"""ResNet family (18/34/50/101/152 and ResNeXt) over NCHW in
``channels_last`` memory.

Counterpart of ``neuralnetworklibrary_tpu/nn/resnet.py``.  Module names
are the flax names (``stem``, ``layer{s}_{i}``, ``b1``/``b2``/``b3``,
``down``, ``conv``, ``bn``, ``fc``), so the JAX package's weights carry
across by ``utils.jax_params.load_jax_params``.  Convolutions take the
explicit (p, p) padding of the JAX modules; the stem's 3x3/2 max-pool pads
by 1 (torch pads it with -inf, as flax does).

A module takes ``train`` and ``bn_train`` as the JAX modules do (see
``nn.layers``).  ``num_classes=None`` builds the body only: ``forward``
returns the (B, C, H/32, W/32) feature map, which
``applications.vision.ImageClassificationNet`` pools;
``return_pyramid=True`` returns [C3, C4, C5] for RetinaNet's FPN.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.nn.layers import (
    BatchNorm,
    conv2d,
    lecun_normal_,
    linear,
    use_running_average,
)
from neuralnetworklibrary_tpu_torch.nn.transformer import resolve_device


class ConvBN(nn.Module):
    """conv (no bias, he_normal) -> bn -> optional relu."""

    def __init__(self, n_in: int, features: int, kernel: int,
                 stride: int = 1, padding: int = 0, use_relu: bool = False,
                 groups: int = 1, device=None):
        super().__init__()
        self.use_relu = use_relu
        self.conv = conv2d(n_in, features, kernel, stride, padding, groups,
                           bias=False, device=device)
        self.bn = BatchNorm(features, device=device)

    def forward(self, x, train: bool = False, bn_train=None):
        x = self.bn(self.conv(x), use_running_average(train, bn_train))
        return F.relu(x) if self.use_relu else x


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (retinanet.py:30-58 semantics)."""

    expansion = 1

    def __init__(self, n_in: int, features: int, stride: int = 1,
                 downsample: bool = False, device=None):
        super().__init__()
        self.b1 = ConvBN(n_in, features, 3, stride, 1, use_relu=True,
                         device=device)
        self.b2 = ConvBN(features, features, 3, 1, 1, device=device)
        self.down = (ConvBN(n_in, features, 1, stride, 0, device=device)
                     if downsample else None)

    def forward(self, x, train: bool = False, bn_train=None):
        out = self.b2(self.b1(x, train, bn_train), train, bn_train)
        identity = x if self.down is None else self.down(x, train, bn_train)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) residual block (retinanet.py:61-98
    semantics); ``groups``/``base_width`` give the ResNeXt variant: the
    inner width is floor(features * base_width / 64) * groups and the 3x3
    is grouped."""

    expansion = 4

    def __init__(self, n_in: int, features: int, stride: int = 1,
                 downsample: bool = False, groups: int = 1,
                 base_width: int = 64, device=None):
        super().__init__()
        width = int(features * (base_width / 64.0)) * groups
        self.b1 = ConvBN(n_in, width, 1, 1, 0, use_relu=True, device=device)
        self.b2 = ConvBN(width, width, 3, stride, 1, use_relu=True,
                         groups=groups, device=device)
        self.b3 = ConvBN(width, features * 4, 1, 1, 0, device=device)
        self.down = (ConvBN(n_in, features * 4, 1, stride, 0, device=device)
                     if downsample else None)

    def forward(self, x, train: bool = False, bn_train=None):
        out = self.b1(x, train, bn_train)
        out = self.b3(self.b2(out, train, bn_train), train, bn_train)
        identity = x if self.down is None else self.down(x, train, bn_train)
        return F.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-compatible ResNet over NCHW (``channels_last``).

    ``num_classes=None`` returns the (B, C, H/32, W/32) feature map (the
    'default_cut' body, Vision.py:1205-1219).  ``return_pyramid=True``
    returns the last maps of stages 2-4, [C3, C4, C5], for the FPN
    (retinanet.py:330-340).  ``device`` defaults to cuda
    (``nn.transformer.resolve_device``).
    """

    def __init__(self, block, layers: Sequence[int],
                 num_classes: Optional[int] = None, groups: int = 1,
                 base_width: int = 64, in_channels: int = 3,
                 return_pyramid: bool = False, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.block, self.layers = block, tuple(layers)
        self.num_classes = num_classes
        self.return_pyramid = return_pyramid
        self.stem = ConvBN(in_channels, 64, 7, 2, 3, use_relu=True,
                           device=dev)
        kw = ({"groups": groups, "base_width": base_width}
              if block is Bottleneck else {})
        planes, in_ch = 64, 64
        for stage, n_blocks in enumerate(self.layers):
            stride = 1 if stage == 0 else 2
            for i in range(n_blocks):
                s = stride if i == 0 else 1
                need_down = s != 1 or in_ch != planes * block.expansion
                self.add_module(f"layer{stage + 1}_{i}", block(
                    in_ch, planes, s, need_down, device=dev, **kw))
                in_ch = planes * block.expansion
            planes *= 2
        self.fc = (linear(in_ch, num_classes, lecun_normal_, device=dev)
                   if num_classes is not None else None)
        self.to(memory_format=torch.channels_last)

    @property
    def feature_channels(self) -> int:
        return 512 * self.block.expansion

    @property
    def pyramid_channels(self):
        e = self.block.expansion
        return [128 * e, 256 * e, 512 * e]

    def forward(self, x, train: bool = False, bn_train=None):
        x = self.stem(x, train, bn_train)
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for stage, n_blocks in enumerate(self.layers):
            for i in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{i}")(x, train, bn_train)
            feats.append(x)
        if self.return_pyramid:
            return feats[1:]
        if self.fc is None:
            return x
        return self.fc(x.mean(dim=(2, 3)))


def _resnet(block, layers, num_classes=None, **kw):
    return ResNet(block, tuple(layers), num_classes, **kw)


resnet18 = partial(_resnet, BasicBlock, (2, 2, 2, 2))
resnet34 = partial(_resnet, BasicBlock, (3, 4, 6, 3))
resnet50 = partial(_resnet, Bottleneck, (3, 4, 6, 3))
resnet101 = partial(_resnet, Bottleneck, (3, 4, 23, 3))
resnet152 = partial(_resnet, Bottleneck, (3, 8, 36, 3))

# ResNeXt feature extractors (the reference's resnext.py:70-137 variants)
resnext101_32x4d = partial(_resnet, Bottleneck, (3, 4, 23, 3), groups=32,
                           base_width=4)
resnext101_64x4d = partial(_resnet, Bottleneck, (3, 4, 23, 3), groups=64,
                           base_width=4)
resnext50_32x4d = partial(_resnet, Bottleneck, (3, 4, 6, 3), groups=32,
                          base_width=4)


def resnet_split_prefixes(layers: Sequence[int]):
    """Differential-lr split of a body: (stem..layer2, layer3..layer4)
    (Vision.py:1221-1242)."""
    g1 = ("stem",) + tuple(
        f"layer{l}_{i}" for l, n in zip((1, 2), layers[:2]) for i in range(n))
    g2 = tuple(
        f"layer{l}_{i}" for l, n in zip((3, 4), layers[2:]) for i in range(n))
    return (g1, g2)
