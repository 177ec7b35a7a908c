"""SENet family (senet154, se_resnet50/101/152, se_resnext50/101_32x4d)
over NCHW in ``channels_last`` memory.

Counterpart of ``neuralnetworklibrary_tpu/nn/senet.py`` (the reference's
VisionModels/senet.py: SEModule :118-138, the bottleneck variants
:165-239, SENet :240-394).  Module names are the flax names (``stem1``..
``stem3``, ``layer{s}_{i}``, ``b1``..``b3``, ``se.fc1``/``fc2``, ``down``,
``last_linear``).  senet154's grouped 3x3 convolutions (groups 64) are
``nn.Conv2d(groups=...)``, flax's ``feature_group_count``; the Caffe-style
3/2 max-pool is torch's ``ceil_mode``, which equals the JAX pad of one
row and column on the bottom and right.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.nn.layers import (
    conv2d,
    lecun_normal_,
    linear,
)
from neuralnetworklibrary_tpu_torch.nn.resnet import ConvBN
from neuralnetworklibrary_tpu_torch.nn.transformer import resolve_device


class SEModule(nn.Module):
    """Squeeze-and-excitation gate (senet.py:118-138): global mean, two
    1x1 convs with bias, sigmoid scale."""

    def __init__(self, channels: int, reduction: int, device=None):
        super().__init__()
        self.fc1 = conv2d(channels, channels // reduction, 1,
                          init=lecun_normal_, device=device)
        self.fc2 = conv2d(channels // reduction, channels, 1,
                          init=lecun_normal_, device=device)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class SEBlock(nn.Module):
    """The SE bottleneck of the three reference variants
    (senet.py:165-239): 'senet' (2x-wide 1x1, then the grouped 3x3 with
    the stride), 'seresnet' (stride on the 1x1), 'seresnext' (width
    floor(planes * base_width / 64) * groups, stride on the 3x3)."""

    def __init__(self, n_in: int, kind: str, planes: int, groups: int,
                 reduction: int, stride: int = 1, downsample: bool = False,
                 down_kernel: int = 1, down_pad: int = 0,
                 base_width: int = 4, device=None):
        super().__init__()
        p = planes
        if kind == "senet":
            c1, s1, g, c2, s2 = p * 2, 1, groups, p * 4, stride
        elif kind == "seresnet":
            c1, s1, g, c2, s2 = p, stride, 1, p, 1
        elif kind == "seresnext":
            width = math.floor(p * (base_width / 64)) * groups
            c1, s1, g, c2, s2 = width, 1, groups, width, stride
        else:
            raise ValueError(kind)
        self.b1 = ConvBN(n_in, c1, 1, s1, 0, use_relu=True, device=device)
        self.b2 = ConvBN(c1, c2, 3, s2, 1, use_relu=True, groups=g,
                         device=device)
        self.b3 = ConvBN(c2, p * 4, 1, 1, 0, device=device)
        self.se = SEModule(p * 4, reduction, device=device)
        self.down = (ConvBN(n_in, p * 4, down_kernel, stride, down_pad,
                            device=device) if downsample else None)

    def forward(self, x, train: bool = False, bn_train=None):
        out = self.b1(x, train, bn_train)
        out = self.se(self.b3(self.b2(out, train, bn_train), train, bn_train))
        identity = x if self.down is None else self.down(x, train, bn_train)
        return F.relu(out + identity)


def _ceil_maxpool_3_2(x):
    """torch MaxPool2d(3, stride=2, ceil_mode=True) (senet.py)."""
    return F.max_pool2d(x, 3, 2, ceil_mode=True)


class SENet(nn.Module):
    """SENet over NCHW (senet.py:240-394).  ``num_classes=None`` returns the
    (B, 2048, H/32, W/32) feature map (the classification-body mode);
    otherwise mean pool, dropout ``dropout_p`` in training, and
    ``last_linear``.  ``device`` defaults to cuda."""

    def __init__(self, kind: str, layers: Sequence[int], groups: int,
                 reduction: int, dropout_p: Optional[float] = 0.2,
                 inplanes: int = 128, input_3x3: bool = True,
                 down_kernel: int = 3, down_pad: int = 1,
                 num_classes: Optional[int] = None, in_channels: int = 3,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.layers, self.dropout_p = tuple(layers), dropout_p
        self.input_3x3 = input_3x3
        if input_3x3:  # senet154 stem (senet.py:290-303)
            self.stem1 = ConvBN(in_channels, 64, 3, 2, 1, use_relu=True,
                                device=dev)
            self.stem2 = ConvBN(64, 64, 3, 1, 1, use_relu=True, device=dev)
            self.stem3 = ConvBN(64, inplanes, 3, 1, 1, use_relu=True,
                                device=dev)
        else:  # 7x7 stem (senet.py:305-311)
            self.stem1 = ConvBN(in_channels, inplanes, 7, 2, 3,
                                use_relu=True, device=dev)
        in_ch, planes = inplanes, 64
        for stage, n_blocks in enumerate(self.layers):
            stride = 1 if stage == 0 else 2
            dk, dp = (1, 0) if stage == 0 else (down_kernel, down_pad)
            for i in range(n_blocks):
                s = stride if i == 0 else 1
                need_down = s != 1 or in_ch != planes * 4
                self.add_module(f"layer{stage + 1}_{i}", SEBlock(
                    in_ch, kind, planes, groups, reduction, s, need_down, dk,
                    dp, device=dev))
                in_ch = planes * 4
            planes *= 2
        self.last_linear = (linear(in_ch, num_classes, lecun_normal_,
                                   device=dev)
                            if num_classes is not None else None)
        self.to(memory_format=torch.channels_last)

    @property
    def feature_channels(self) -> int:
        return 2048

    def forward(self, x, train: bool = False, bn_train=None):
        stems = ("stem1", "stem2", "stem3") if self.input_3x3 else ("stem1",)
        for name in stems:
            x = getattr(self, name)(x, train, bn_train)
        x = _ceil_maxpool_3_2(x)
        for stage, n_blocks in enumerate(self.layers):
            for i in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x, train, bn_train)
        if self.last_linear is None:
            return x
        x = x.mean(dim=(2, 3))
        if self.dropout_p and train:
            x = F.dropout(x, self.dropout_p)
        return self.last_linear(x)


def senet154(num_classes=None, **kw):
    return SENet("senet", (3, 8, 36, 3), 64, 16, dropout_p=0.2,
                 num_classes=num_classes, **kw)


def se_resnet(layers, num_classes=None, **kw):
    return SENet("seresnet", tuple(layers), 1, 16, dropout_p=None,
                 inplanes=64, input_3x3=False, down_kernel=1, down_pad=0,
                 num_classes=num_classes, **kw)


se_resnet50 = partial(se_resnet, (3, 4, 6, 3))
se_resnet101 = partial(se_resnet, (3, 4, 23, 3))
se_resnet152 = partial(se_resnet, (3, 8, 36, 3))


def se_resnext(layers, num_classes=None, **kw):
    return SENet("seresnext", tuple(layers), 32, 16, dropout_p=None,
                 inplanes=64, input_3x3=False, down_kernel=1, down_pad=0,
                 num_classes=num_classes, **kw)


se_resnext50_32x4d = partial(se_resnext, (3, 4, 6, 3))
se_resnext101_32x4d = partial(se_resnext, (3, 4, 23, 3))


def senet_split_prefixes(layers: Sequence[int]):
    """Differential-lr split: (stem..layer2, layer3..layer4), the analogue
    of Vision.py:1221-1242 for SENet bodies."""
    g1 = ("stem1", "stem2", "stem3") + tuple(
        f"layer{l}_{i}" for l, n in zip((1, 2), layers[:2]) for i in range(n))
    g2 = tuple(
        f"layer{l}_{i}" for l, n in zip((3, 4), layers[2:]) for i in range(n))
    return (g1, g2)
