"""RetinaNet parts over NCHW in ``channels_last`` memory: the FPN, the box
subnets and the anchors.

Counterpart of ``neuralnetworklibrary_tpu/nn/retinanet.py`` (the
reference's VisionModels/retinanet.py).  Module names are the flax names
(``P5_1`` ... ``P7_2``; ``bn0``-``bn4``, ``conv1``-``conv4``, ``output``),
so the JAX package's weights carry across by
``utils.jax_params.load_jax_params``.

- :class:`FPN`: P3-P7 from ResNet's [C3, C4, C5] (retinanet.py:101-148); the
  nearest x2 upsample of P5 (P4) is cropped to C4's (C3's) size, which it
  overshoots by one where that size is odd.
- :class:`BoxSubNet`: four 3x3 convs + an output conv (retinanet.py:
  150-296), with optional BatchNorm (flax momentum 0.01: the running
  statistics keep 1% of their old value) and dropout; the output kernel
  starts at zero and its bias at the ``prior`` logit (classification) or
  zero (regression).  The output (B, A*out, H, W) is permuted to (B, H, W,
  A*out) before the reshape to (B, H*W*A, out): rows are anchor-major
  within a cell, cell-major over the map, the order of
  :func:`generate_anchors`.
- The anchor functions are numpy, copied: a function of the padded image
  shape only.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.nn.layers import (
    BatchNorm,
    conv2d,
    use_running_average,
)


def he_out_(t: torch.Tensor) -> torch.Tensor:
    """flax ``variance_scaling(2.0, 'fan_out', 'normal')``, in place."""
    return nn.init.kaiming_normal_(t, mode="fan_out", nonlinearity="relu")


def _conv(n_in, features, kernel, stride=1, device=None):
    return conv2d(n_in, features, kernel, stride, kernel // 2, init=he_out_,
                  device=device)


def _upsample2x(x):
    """Nearest-neighbour x2 (nn.Upsample(scale_factor=2),
    retinanet.py:106)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class FPN(nn.Module):
    """Feature pyramid P3-P7 from [C3, C4, C5] (retinanet.py:101-148)."""

    def __init__(self, in_channels, feature_size: int = 256, device=None):
        super().__init__()
        c3, c4, c5 = in_channels
        f = feature_size
        self.P5_1 = _conv(c5, f, 1, device=device)
        self.P5_2 = _conv(f, f, 3, device=device)
        self.P4_1 = _conv(c4, f, 1, device=device)
        self.P4_2 = _conv(f, f, 3, device=device)
        self.P3_1 = _conv(c3, f, 1, device=device)
        self.P3_2 = _conv(f, f, 3, device=device)
        self.P6 = _conv(c5, f, 3, 2, device=device)
        self.P7_2 = _conv(f, f, 3, 2, device=device)

    def forward(self, c3, c4, c5):
        p5 = self.P5_1(c5)
        p5_up = _upsample2x(p5)
        p5 = self.P5_2(p5)

        p4 = self.P4_1(c4)
        p4 = p4 + p5_up[:, :, :p4.shape[2], :p4.shape[3]]
        p4_up = _upsample2x(p4)
        p4 = self.P4_2(p4)

        p3 = self.P3_1(c3)
        p3 = p3 + p4_up[:, :, :p3.shape[2], :p3.shape[3]]
        p3 = self.P3_2(p3)

        p6 = self.P6(c5)
        p7 = self.P7_2(F.relu(p6))
        return [p3, p4, p5, p6, p7]


class BoxSubNet(nn.Module):
    """Shared 4-conv subnet + output conv (retinanet.py:150-296).

    ``out_per_anchor`` 4 with a zero output -> the regression subnet;
    ``num_classes`` with the ``prior`` bias and ``sigmoid_out`` -> the
    classification subnet.  ``forward`` maps (B, F, H, W) to (B, H*W*A,
    out_per_anchor)."""

    def __init__(self, num_anchors: int = 9, out_per_anchor: int = 4,
                 feature_size: int = 256, use_bn: bool = False,
                 drop: Optional[tuple] = None, prior: Optional[float] = None,
                 sigmoid_out: bool = False, device=None):
        super().__init__()
        f = feature_size
        self.out_per_anchor = out_per_anchor
        self.use_bn, self.drop, self.sigmoid_out = use_bn, drop, sigmoid_out
        for i in range(1, 5):
            setattr(self, f"conv{i}", _conv(f, f, 3, device=device))
        if use_bn:
            for i in range(5):
                setattr(self, f"bn{i}", BatchNorm(f, momentum=0.99,
                                                  device=device))
        self.output = nn.Conv2d(f, num_anchors * out_per_anchor, 3,
                                padding=1, device=device)
        nn.init.zeros_(self.output.weight)
        nn.init.constant_(self.output.bias, 0.0 if prior is None else
                          -math.log((1.0 - prior) / prior))

    def forward(self, x, train: bool = False,
                bn_train: Optional[bool] = None):
        use_ra = use_running_average(train, bn_train)
        if self.use_bn:
            x = self.bn0(x, use_ra)
        if self.drop:
            x = F.dropout(x, self.drop[0], training=train)
        for i in range(1, 5):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if self.use_bn:
                x = getattr(self, f"bn{i}")(x, use_ra)
            if self.drop:
                x = F.dropout(x, self.drop[1], training=train)
        x = self.output(x).permute(0, 2, 3, 1)
        x = x.reshape(x.shape[0], -1, self.out_per_anchor)
        return torch.sigmoid(x) if self.sigmoid_out else x


# ---------------------------------------------------------------------------
# Anchor generation (retinanet.py:439-495): numpy over static shapes
# ---------------------------------------------------------------------------

DEFAULT_RATIOS = (0.5, 1.0, 2.0)
DEFAULT_SCALES = (2 ** 0, 2 ** (1 / 3), 2 ** (2 / 3))
PYRAMID_LEVELS = (3, 4, 5, 6, 7)


def get_anchor_set(ratios=DEFAULT_RATIOS, scales=DEFAULT_SCALES) -> np.ndarray:
    """Base anchors around the unit square centred at (0, 0) -> (A, 4)
    min-max (retinanet.py:439-450); ratio-major, scale-minor."""
    S = np.tile(scales, len(ratios))
    R = np.repeat(ratios, len(scales))
    H = S / np.sqrt(R)
    W = S * np.sqrt(R)
    return np.stack([-W / 2, -H / 2, W / 2, H / 2], axis=1).astype(np.float32)


def get_anchor_shifts(shape, stride, anchors) -> np.ndarray:
    """Tile base anchors over an (H, W) grid of stride-sized cells, centres
    at the cells' midpoints (retinanet.py:453-471) -> (H*W*A, 4),
    cell-major."""
    sx = (np.arange(shape[1]) + 0.5) * stride
    sy = (np.arange(shape[0]) + 0.5) * stride
    SX, SY = np.meshgrid(sx, sy)
    shifts = np.stack([SX.ravel(), SY.ravel(), SX.ravel(), SY.ravel()], axis=1)
    out = anchors[None, :, :] + shifts[:, None, :]
    return out.reshape(-1, 4).astype(np.float32)


def generate_anchors(img_shape, ratios=DEFAULT_RATIOS, scales=DEFAULT_SCALES,
                     levels=PYRAMID_LEVELS) -> np.ndarray:
    """All anchors of an (H, W) image over pyramid levels 3-7: stride 2^l,
    size 2^(l+2), grid ceil(dim / 2^l) (retinanet.py:473-495) -> (N, 4)."""
    img_shape = np.asarray(img_shape[:2])
    base = get_anchor_set(ratios, scales)
    all_anchors = []
    for l in levels:
        grid = (img_shape + 2 ** l - 1) // (2 ** l)
        size = 2 ** (l + 2)
        all_anchors.append(get_anchor_shifts(grid, 2 ** l, size * base))
    return np.concatenate(all_anchors)


def num_anchors_for(img_shape, num_per_cell=9, levels=PYRAMID_LEVELS) -> int:
    h, w = int(img_shape[0]), int(img_shape[1])
    n = 0
    for l in levels:
        n += -(-h // 2 ** l) * -(-w // 2 ** l) * num_per_cell
    return n
