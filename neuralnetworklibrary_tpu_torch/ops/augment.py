"""Batched image augmentation on the batch's device.

Counterpart of ``neuralnetworklibrary_tpu/ops/augment.py`` (the random
stages of the reference's Transform, Vision.py:449-507).  Batches cross to
the device as uint8 NHWC and become float32 there.  The stages, in the
JAX order: an optional rotate-zoom as one bilinear inverse warp with
cv2's BORDER_REFLECT (``warp_affine_batch``); the left-right flip and the
dihedral rotations as reversals; brightness and contrast about each
image's channel means; gaussian-blurred uniform noise; normalization.

The random parameters are drawn apart from the stages that use them:
:func:`draw_augment_params` draws them from a ``torch.Generator`` on the
batch's device, and :func:`apply_augment` applies a given draw, so every
stage can be held exactly against the JAX function on the same
parameters.  :func:`augment_batch` is the two together.

The warp is written as JAX writes it, index arithmetic and a gather:
``F.grid_sample``'s reflection padding is not cv2's BORDER_REFLECT.
Not ported yet: ``cached_augment_batch`` and ``warp_affine_two_pass``
(the device cache of ``ImageLearner.enable_device_cache``; ROADMAP
Queue 1).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

# Normalization stats (Vision.py:46-47).
imagenet_stats = [np.array([0.485, 0.456, 0.406]),
                  np.array([0.229, 0.224, 0.225])]
alternate_stats = [np.array([0.5, 0.5, 0.5]), np.array([0.5, 0.5, 0.5])]


def _reflect_index(idx, size: int):
    """cv2 BORDER_REFLECT: -1 -> 0, -2 -> 1, size -> size-1 (the edge is
    repeated); clipped to the image for samples further out."""
    idx = torch.where(idx < 0, -idx - 1, idx)
    idx = torch.where(idx >= size, 2 * size - 1 - idx, idx)
    return idx.clamp(0, size - 1)


def warp_affine_batch(imgs: torch.Tensor, A: torch.Tensor, b: torch.Tensor,
                      out_hw=None) -> torch.Tensor:
    """Inverse-warp a batch of NHWC images by per-image affine maps.

    Output pixel p = (x, y) samples the input at q = A @ p + b, bilinearly,
    with reflect borders (cv2.warpAffine, Vision.py:493-495; (x, y) is
    (col, row)).  imgs (B, H, W, C) float; A (B, 2, 2); b (B, 2).
    ``out_hw`` = (oh, ow) is the output grid, the input's (H, W) by
    default: a smaller grid folds a crop into the same gather.
    """
    B, H, W, C = imgs.shape
    oh, ow = (H, W) if out_hw is None else out_hw
    dev = imgs.device
    X, Y = torch.meshgrid(torch.arange(ow, dtype=torch.float32, device=dev),
                          torch.arange(oh, dtype=torch.float32, device=dev),
                          indexing="xy")                     # (oh, ow)
    A = A.float()
    b = b.float()
    sx = (A[:, 0, 0, None, None] * X + A[:, 0, 1, None, None] * Y
          + b[:, 0, None, None])
    sy = (A[:, 1, 0, None, None] * X + A[:, 1, 1, None, None] * Y
          + b[:, 1, None, None])
    x0f, y0f = torch.floor(sx), torch.floor(sy)
    fx, fy = (sx - x0f)[..., None], (sy - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    x0r, x1r = _reflect_index(x0, W), _reflect_index(x0 + 1, W)
    y0r, y1r = _reflect_index(y0, H), _reflect_index(y0 + 1, H)
    flat = imgs.reshape(B, H * W, C)

    def gather(yy, xx):
        idx = (yy * W + xx).reshape(B, oh * ow, 1).expand(-1, -1, C)
        return flat.gather(1, idx).reshape(B, oh, ow, C)

    top = gather(y0r, x0r) * (1 - fx) + gather(y0r, x1r) * fx
    bot = gather(y1r, x0r) * (1 - fx) + gather(y1r, x1r) * fx
    return top * (1 - fy) + bot * fy


def _compose(A1, b1, A2, b2):
    """The map q = A1 @ (A2 @ p + b2) + b1, as (A, b)."""
    return (torch.einsum("bij,bjk->bik", A1, A2),
            torch.einsum("bij,bj->bi", A1, b2) + b1)


def _identity_affine(B: int, device=None):
    A = torch.eye(2, dtype=torch.float32, device=device).expand(B, 2, 2)
    return A, torch.zeros(B, 2, dtype=torch.float32, device=device)


def _rot_zoom_inverse(deg, zoom, cx, cy):
    """Inverse of cv2.getRotationMatrix2D(center, deg, zoom) as (A, b):
    rotate by -deg, scale by 1/zoom, about (cx, cy)."""
    th = -deg * (np.pi / 180.0)
    s = 1.0 / zoom
    cos, sin = torch.cos(th) * s, torch.sin(th) * s
    A = torch.stack([torch.stack([cos, sin], -1),
                     torch.stack([-sin, cos], -1)], -2)
    c = torch.stack([torch.full_like(deg, float(cx)),
                     torch.full_like(deg, float(cy))], -1)
    return A, c - torch.einsum("bij,bj->bi", A, c)


def _dihedral_inverse(flip, rot, size: int):
    """Inverse affine of (LR flip where ``flip``) then np.rot90 ``rot``
    times, on a (size, size) image, in (x, y) coordinates.  np.rot90
    (counter-clockwise): the source of output pixel (x, y) is (N-1-y, x)."""
    N = float(size - 1)
    dev = flip.device
    rotA = torch.tensor([[[1.0, 0.0], [0.0, 1.0]],
                         [[0.0, -1.0], [1.0, 0.0]],
                         [[-1.0, 0.0], [0.0, -1.0]],
                         [[0.0, 1.0], [-1.0, 0.0]]], device=dev)
    rotb = torch.tensor([[0.0, 0.0], [N, 0.0], [N, N], [0.0, N]],
                        device=dev)
    rot = rot.long()
    fl = flip.bool()
    flipA = torch.where(fl[:, None, None],
                        torch.tensor([[-1.0, 0.0], [0.0, 1.0]], device=dev),
                        torch.eye(2, device=dev))
    flipb = torch.where(fl[:, None], torch.tensor([N, 0.0], device=dev),
                        torch.zeros(2, device=dev))
    return _compose(flipA, flipb, rotA[rot], rotb[rot])


def _gaussian_kernel1d(ksize: int = 11, sigma: Optional[float] = None):
    """cv2.getGaussianKernel: sigma <= 0 means 0.3*((ksize-1)*0.5-1)+0.8."""
    if sigma is None or sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize) - (ksize - 1) / 2
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _blur_separable(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Depthwise separable gaussian blur of an NHWC batch, zero padding:
    along H, then along W."""
    C, K = x.shape[-1], len(k1d)
    k = torch.from_numpy(np.asarray(k1d, np.float32)).to(x.device)
    pad = (K - 1) // 2
    y = x.permute(0, 3, 1, 2)
    y = F.conv2d(y, k.reshape(1, 1, K, 1).expand(C, 1, K, 1),
                 padding=(pad, 0), groups=C)
    y = F.conv2d(y, k.reshape(1, 1, 1, K).expand(C, 1, 1, K),
                 padding=(0, pad), groups=C)
    return y.permute(0, 2, 3, 1)


def _stats_tensors(stats, device):
    return tuple(torch.as_tensor(np.asarray(s, np.float32).ravel(),
                                 device=device) for s in stats)


def normalize_batch(imgs: torch.Tensor, stats) -> torch.Tensor:
    """uint8 or float NHWC -> float32 (uint8 / 255) -> (x - mean) / std
    (Vision.py:505); ``stats`` None skips the last step."""
    x = imgs.float()
    if imgs.dtype == torch.uint8:
        x = x / 255.0
    if stats is not None:
        mean, std = _stats_tensors(stats, x.device)
        x = (x - mean) / std
    return x


def _uniform(shape, lo, hi, generator, device):
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def draw_augment_params(generator, imgs: torch.Tensor, *, tfm_type="Basic",
                        max_deg=10, max_zoom=1.05, bal_range=(-0.05, 0.05),
                        cont_range=(0.95, 1.05), max_noise=None) -> dict:
    """The random parameters of one :func:`augment_batch` call, drawn from
    ``generator`` (a ``torch.Generator`` on the batch's device) with the
    JAX distributions: ``deg`` U(-max_deg, max_deg) and ``zoom`` U(1,
    max_zoom or 1) where ``max_deg`` is set; ``flip`` in {0, 1} for
    'SideOn' and 'TopDown', and ``rot`` in {0..3} for 'TopDown'; ``bal``
    and ``cont`` (B, 1, 1, 1) where ``bal_range`` is set (``cont_range``
    None: cont 1); ``noise`` (B, H, W, C) U(-max_noise, max_noise) where
    ``max_noise``.  Stages that do not run get no entry."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    p = {}
    if max_deg is not None:
        p["deg"] = _uniform((B,), -float(max_deg), float(max_deg),
                            generator, dev)
        p["zoom"] = _uniform((B,), 1.0, float(max_zoom) if max_zoom else 1.0,
                             generator, dev)
    if tfm_type in ("SideOn", "TopDown"):
        p["flip"] = torch.randint(0, 2, (B,), generator=generator,
                                  device=dev)
        if tfm_type == "TopDown":
            p["rot"] = torch.randint(0, 4, (B,), generator=generator,
                                     device=dev)
    if bal_range is not None:
        cont_lo, cont_hi = (1.0, 1.0) if cont_range is None else cont_range
        p["bal"] = _uniform((B, 1, 1, 1), float(bal_range[0]),
                            float(bal_range[1]), generator, dev)
        p["cont"] = _uniform((B, 1, 1, 1), float(cont_lo), float(cont_hi),
                             generator, dev)
    if max_noise:
        p["noise"] = _uniform((B, H, W, C), -float(max_noise),
                              float(max_noise), generator, dev)
    return p


def apply_augment(imgs: torch.Tensor, params: dict,
                  stats=imagenet_stats) -> torch.Tensor:
    """The stages of :func:`augment_batch` on a uint8 or float NHWC batch,
    given its parameters (:func:`draw_augment_params`); a stage runs where
    ``params`` has its entries."""
    B, H, W, C = imgs.shape
    x = imgs.float()
    if imgs.dtype == torch.uint8:
        x = x / 255.0
    if "deg" in params:
        A, b = _rot_zoom_inverse(params["deg"], params["zoom"], W // 2,
                                 H // 2)
        x = warp_affine_batch(x, A, b)
    if "flip" in params:
        x = torch.where(params["flip"].bool()[:, None, None, None],
                        x.flip(2), x)
    if "rot" in params:
        if H != W:
            raise ValueError("TopDown dihedral rotations require square "
                             "images")
        stacked = torch.stack([torch.rot90(x, k, (1, 2)) for k in range(4)])
        x = stacked[params["rot"].long(), torch.arange(B, device=x.device)]
    if "bal" in params:
        mu = x.mean(dim=(1, 2), keepdim=True)
        x = ((x - mu) * params["cont"] + params["bal"] + mu).clamp(0.0, 1.0)
    if "noise" in params:
        x = (x + _blur_separable(params["noise"], _gaussian_kernel1d(11))
             ).clamp(0.0, 1.0)
    if stats is not None:
        mean, std = _stats_tensors(stats, x.device)
        x = (x - mean) / std
    return x


def augment_batch(generator, imgs, *, tfm_type="Basic", max_deg=10,
                  max_zoom=1.05, bal_range=(-0.05, 0.05),
                  cont_range=(0.95, 1.05), max_noise=None,
                  stats=imagenet_stats):
    """Random train-time augmentation of a uint8 or float NHWC batch on its
    device (the random stages of the reference Transform, Vision.py:449-
    507, with its parameter semantics): :func:`draw_augment_params` from
    ``generator``, then :func:`apply_augment`."""
    params = draw_augment_params(
        generator, imgs, tfm_type=tfm_type, max_deg=max_deg,
        max_zoom=max_zoom, bal_range=bal_range, cont_range=cont_range,
        max_noise=max_noise)
    return apply_augment(imgs, params, stats)
