"""Image classification: transforms, models and the ImageLearner.

Counterpart of the classification half of
``neuralnetworklibrary_tpu/applications/vision.py`` (Applications/
Vision.py of the reference).  The input pipeline is split as in JAX:

- host, per sample: pad (numpy 'symmetric', which is cv2's
  BORDER_REFLECT) and crop to a uint8 (sz, sz, 3) array;
- device, per batch, inside the train step: flip or dihedral, lighting,
  blurred noise and normalization (``ops.augment``), from the Learner's
  device generator.

Model: :class:`ImageClassificationNet` = a body (``nn.resnet`` or
``nn.senet`` features) + a concat-pool ``FullyConnectedNet`` head
(Vision.py:1244-1337), the body split in two layer groups and the head
the third.  It takes NHWC images, as the JAX model does, and hands the
body their NCHW view in ``channels_last`` memory.

Not ported yet (ROADMAP Queue 1): the host resize and rotate-zoom (they
need cv2), the file-based ``ImageDataset``/``ImageDataObj`` (``from_csv``,
``from_folders``), ``ImageLearner.enable_device_cache``, ``data_resize``,
``TTA``, ``confusion_matrix``, ``show_images`` and ``ShowImages``,
``load_pretrained_body``, and the inception and nasnet bodies.  The bbox
helpers that detection imports (``open_image``, ``hw_to_mm``,
``get_AspectRatioScale``, ...) are here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.nn import resnet as _resnet_mod
from neuralnetworklibrary_tpu_torch.nn import senet as _senet_mod
from neuralnetworklibrary_tpu_torch.nn.layers import (
    FullyConnectedNet,
    adaptive_concat_pool2d,
)
from neuralnetworklibrary_tpu_torch.nn.transformer import resolve_device
from neuralnetworklibrary_tpu_torch.ops.augment import (  # noqa: F401
    alternate_stats,
    augment_batch,
    imagenet_stats,
    normalize_batch,
)

_TODO = "is not ported yet (ROADMAP Queue 1)"

# mAP threshold sets (Vision.py:48-49)
Pascal_thresholds = [0.5]
COCO_thresholds = [0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85, 0.9, 0.95]


def correct_foldername(p: str) -> str:
    return p if p.endswith("/") else p + "/"


def open_image(img_name: str) -> np.ndarray:
    """cv2 image open -> RGB float32 in [0, 1], (H, W, 3) (Vision.py:54-62).
    cv2 is imported here: the card's machine has none."""
    import cv2

    flags = cv2.IMREAD_UNCHANGED + cv2.IMREAD_ANYCOLOR
    img = cv2.imread(img_name, flags)
    if img is None:
        raise FileNotFoundError(img_name)
    img = img.astype(np.float32) / 255
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    return img[:, :, ::-1].copy()  # BGR -> RGB


def hw_to_mm(b):
    """[x, y, w, h] -> [x_min, y_min, x_max, y_max], inclusive-pixel
    convention (x_max = x + w - 1; Vision.py:191-193)."""
    b = np.asarray(b, np.float32)
    return np.concatenate([b[..., :2], b[..., :2] + b[..., 2:] - 1], axis=-1)


def mm_to_hw(b):
    """[x_min, y_min, x_max, y_max] -> [x, y, w, h] (w = x_max - x_min + 1;
    Vision.py:195-197)."""
    b = np.asarray(b, np.float32)
    return np.concatenate([b[..., :2], b[..., 2:] - b[..., :2] + 1], axis=-1)


def convert_bbox_list(bbox_list):
    """Standard bbox list [(box, cat), ...] -> ((N, 4) boxes, (N,) cats)
    (Vision.py:199-210); the boxes pass through unchanged (min-max)."""
    if len(bbox_list) == 0:
        return np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
    boxes = np.asarray([b for b, c in bbox_list], np.float32)
    cats = np.asarray([c for b, c in bbox_list], np.int64)
    return boxes, cats


def rev_bbox_list(boxes, cats):
    """Inverse of :func:`convert_bbox_list`, stopping at the first -1
    padding row (Vision.py:212-232)."""
    boxes = np.asarray(boxes, np.float32)
    cats = np.asarray(cats)
    out = []
    for i in range(len(cats)):
        if cats[i] == -1:
            break
        out.append((boxes[i], int(cats[i])))
    return out


def get_AspectRatioScale(rows, cols, min_side=608, max_side=1216):
    """RetinaNet's scale rule: the shorter side to ``min_side`` unless the
    longer one would pass ``max_side`` (Vision.py:258-269).  Returns
    (rows / cols, scale)."""
    smallest, largest = min(rows, cols), max(rows, cols)
    scale = min_side / smallest
    if largest * scale > max_side:
        scale = max_side / largest
    return rows / cols, scale


class Transform:
    """Image transform with the reference's parameters (Vision.py:
    399-447), split host / device.

    host ``__call__(img, rng=None)``: pad (reflect) -> crop (center,
    'random' or a fractional crop point) -> uint8 (sz, sz, 3).  A resize
    to another size, and the rotate-zoom of ``max_deg``, need cv2 and
    raise NotImplementedError.
    device ``device_apply(generator, batch, train)``: flip or dihedral,
    lighting, noise and normalization (``ops.augment``).
    """

    def __init__(self, tfm_type, crop_type, pad=None, sz=224, max_deg=10,
                 max_zoom=1.05, bal_range=(-0.05, 0.05),
                 cont_range=(0.95, 1.05), max_noise=None,
                 stats=imagenet_stats):
        if isinstance(sz, int):
            sz = (sz, sz)
        self.tfm_type, self.crop_type = tfm_type, crop_type
        self.pad, self.sz = pad, tuple(sz) if sz else None
        self.max_deg, self.max_zoom = max_deg, max_zoom
        self.bal_range = tuple(bal_range) if bal_range is not None else None
        self.cont_range = (tuple(cont_range) if cont_range is not None
                           else None)
        self.max_noise, self.stats = max_noise, stats
        self._rng = np.random.default_rng()

    @property
    def has_random_geometry(self):
        return bool(self.max_deg) or self.tfm_type in ("SideOn", "TopDown")

    def _draw(self, rng, high):
        return int((self._rng if rng is None else rng).integers(0, high))

    def __call__(self, img: np.ndarray, rng=None) -> np.ndarray:
        """img (H, W, 3) uint8 or float in [0, 1] -> (sz, sz, 3) uint8."""
        if self.max_deg:
            raise NotImplementedError(f"the host rotate-zoom (cv2) {_TODO}")
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        if self.pad:
            p = self.pad
            img = np.pad(img, ((p, p), (p, p), (0, 0)), mode="symmetric")
        rows, cols = img.shape[:2]
        L = min(rows, cols)
        if self.crop_type is not None and (rows > L or cols > L):
            n = max(rows, cols) - L
            if self.crop_type == "center":
                r = n // 2
            elif self.crop_type == "random":
                r = self._draw(rng, n + 1)
            else:
                r = int(n * float(self.crop_type))
            img = img[r:r + L, :] if rows > L else img[:, r:r + L]
        if self.sz and img.shape[:2] != self.sz:
            raise NotImplementedError(f"the host resize (cv2) {_TODO}")
        return img

    def device_apply(self, generator, batch, train: bool):
        """Per-batch device stages.  The rotate-zoom belongs to the host
        half, so the device warp does not run here (as in JAX)."""
        if train and (self.has_random_geometry or self.bal_range
                      or self.max_noise):
            if generator is None:
                generator = torch.Generator(batch.device).manual_seed(0)
            return augment_batch(
                generator, batch, tfm_type=self.tfm_type, max_deg=None,
                max_zoom=None, bal_range=self.bal_range,
                cont_range=self.cont_range, max_noise=self.max_noise,
                stats=self.stats)
        return normalize_batch(batch, self.stats)


def get_transforms(tfm_type, sz=224, stats=imagenet_stats):
    """[tfm_eval, tfm_aug] (Vision.py:509-517)."""
    tfm_eval = Transform("Basic", "center", None, sz, None, None, None, None,
                         stats=stats)
    tfm_aug = Transform(tfm_type, "random", None, sz, stats=stats)
    return [tfm_eval, tfm_aug]


# body registry: name -> (constructor of the features-only body, layers,
# bottleneck?)
body_archs = {
    "resnet18": (_resnet_mod.resnet18, (2, 2, 2, 2), False),
    "resnet34": (_resnet_mod.resnet34, (3, 4, 6, 3), False),
    "resnet50": (_resnet_mod.resnet50, (3, 4, 6, 3), True),
    "resnet101": (_resnet_mod.resnet101, (3, 4, 23, 3), True),
    "resnet152": (_resnet_mod.resnet152, (3, 8, 36, 3), True),
    "resnext101_32x4d": (_resnet_mod.resnext101_32x4d, (3, 4, 23, 3), True),
    "resnext101_64x4d": (_resnet_mod.resnext101_64x4d, (3, 4, 23, 3), True),
    "resnext50_32x4d": (_resnet_mod.resnext50_32x4d, (3, 4, 6, 3), True),
}


def build_body(arch: str, device=None):
    """(features module, nfeats, layer-group split) of a model-zoo arch
    (the reference's default_cut/default_split, Vision.py:1205-1242)."""
    if arch in body_archs:
        ctor, layers, _ = body_archs[arch]
        body = ctor(device=device)
        return (body, body.feature_channels,
                _resnet_mod.resnet_split_prefixes(layers))
    if arch.startswith("se") and hasattr(_senet_mod, arch):
        body = getattr(_senet_mod, arch)(device=device)
        return (body, body.feature_channels,
                _senet_mod.senet_split_prefixes(body.layers))
    if arch in ("inceptionv4", "inceptionresnetv2", "nasnetalarge"):
        raise NotImplementedError(f"the {arch} body {_TODO}")
    raise KeyError(f"unknown arch '{arch}'")


class ImageClassificationNet(nn.Module):
    """body (features) + concat-pool MLP head (Vision.py:1244-1337).

    ``body`` is any module mapping NCHW images to (B, C, h, w) features;
    the head is AdaptiveConcatPool -> FullyConnectedNet([2C, *hidden,
    n_cats]) (Vision.py:1310-1317).  Layer groups: the two halves of
    ``body_split`` and the head, or (body, head).  ``bn_frozen`` 'non_head'
    keeps the body's BatchNorms on their running statistics in training,
    'all' the head's too (``Learner.bn_freeze``).
    """

    head_prefixes = ("head",)

    def __init__(self, body: nn.Module, head_layer_sizes,
                 head_drops=(0.25, 0.25), body_split=None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.body = body.to(dev)
        self.head_layer_sizes = tuple(head_layer_sizes)
        self.body_split = body_split
        self.head = FullyConnectedNet(self.head_layer_sizes,
                                      tuple(head_drops), device=dev)

    @property
    def layer_group_prefixes(self):
        if self.body_split is None:
            return (("body",), ("head",))
        return tuple(tuple("body." + p for p in g)
                     for g in self.body_split) + (("head",),)

    def forward(self, x, train: bool = False,
                bn_frozen: Optional[str] = None):
        """x (B, H, W, C) float images -> (B, n_cats) logits."""
        body_bn_train = False if bn_frozen in ("all", "non_head") else None
        head_bn_train = False if bn_frozen == "all" else None
        feats = self.body(x.permute(0, 3, 1, 2), train=train,
                          bn_train=body_bn_train)
        return self.head(adaptive_concat_pool2d(feats), train=train,
                         bn_train=head_bn_train)

    @classmethod
    def create(cls, data, arch="resnet34", head="default", device=None):
        """Build from a data object and an arch name or a (module, nfeats,
        split) triple (the reference's __init__, Vision.py:1297-1331)."""
        if isinstance(arch, str):
            body, nfeats, split = build_body(arch, device=device)
        else:
            body, nfeats, split = arch
        hidden, drops = ([512], (0.25, 0.25)) if head == "default" else head
        sizes = (2 * nfeats,) + tuple(hidden) + (len(data.categories),)
        return cls(body, sizes, tuple(drops),
                   tuple(tuple(g) for g in split) if split else None,
                   device=device)


class ImageClassificationEnsembleNet(nn.Module):
    """Weighted average of classification nets after softmax (or sigmoid
    for 'multi_label') (Vision.py:1339-1373); members under
    ``models_{i}``."""

    layer_group_prefixes = None
    head_prefixes = ("head",)

    def __init__(self, models, weights=None, correction="single_label"):
        super().__init__()
        self.n_models = len(models)
        for i, m in enumerate(models):
            self.add_module(f"models_{i}", m)
        self.weights = (tuple(weights) if weights is not None
                        else (1.0 / self.n_models,) * self.n_models)
        self.correction = correction

    def forward(self, x, train: bool = False,
                bn_frozen: Optional[str] = None):
        out = 0.0
        for i in range(self.n_models):
            y = getattr(self, f"models_{i}")(x, train=train,
                                             bn_frozen=bn_frozen)
            y = (torch.softmax(y, dim=1) if self.correction == "single_label"
                 else torch.sigmoid(y))
            out = out + self.weights[i] * y
        return out


class ImageLearner(Learner):
    """Learner with the image input pipeline (the data object's transforms
    on the device) and mixed precision on by default: ``compute_dtype``
    'bfloat16', as in JAX (parameters, optimizer state, BatchNorm
    statistics and the loss stay float32).  Pass ``compute_dtype=None``
    for float32.  ``data`` needs ``transforms`` = [tfm_eval, tfm_aug]."""

    def __init__(self, PATH, data, model, optimizer="default",
                 loss_func="default", use_moving_avg=True, seed=0,
                 compute_dtype="bfloat16", **learner_kwargs):
        super().__init__(PATH, data, model, optimizer, loss_func,
                         use_moving_avg, seed=seed,
                         input_pipeline=self._build_pipeline(data),
                         compute_dtype=compute_dtype, **learner_kwargs)

    @staticmethod
    def _build_pipeline(data):
        tfm_eval, tfm_aug = data.transforms[0], data.transforms[1]

        def pipeline(generator, xs, train):
            tfm = tfm_aug if train else tfm_eval
            return (tfm.device_apply(generator, xs[0], train),) + tuple(
                xs[1:])

        return pipeline

    def switch_transform_stats(self, new_stats):
        """Swap the normalization stats of the data object's transforms
        (Vision.py:1835-1844)."""
        for tfm in self.data.transforms:
            tfm.stats = new_stats
        self.set_input_pipeline(self._build_pipeline(self.data))
