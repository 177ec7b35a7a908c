"""Bounding-box object detection: data, RetinaNet, losses, NMS, mAP and
the ObjectDetectionLearner.

Counterpart of ``neuralnetworklibrary_tpu/applications/detection.py`` (the
detection half of the reference's Vision.py and the predictor half of
VisionModels/retinanet.py).  What carries over:

- images are aspect-ratio bucketed and padded to a few static (H, W)
  shapes (``granularity``), box lists to one dataset-wide ``max_objects``
  with -1 rows; batches cross to the device as uint8 and are normalized
  there;
- the SSD loss (anchor matching, focal loss, smooth-L1) is one batched
  computation over the images, the -1 padding as its mask;
- decode, threshold and greedy NMS run on the device for the whole batch
  (``ops.boxes``); the host gets only the (B, out_k) survivors, in one
  copy, and applies the optional prune passes (rel_thresh / inc / dup);
- ``enable_device_cache`` keeps every image, scaled and padded once, on
  the card as one uint8 canvas array; a train batch then sends only its
  rows, flips and boxes, and inference gathers, flips, jitters,
  normalizes, runs the model, decodes and suppresses on the device.

What differs: the model is NCHW in ``channels_last`` memory (it takes NHWC
images, as the JAX model does); its anchors are computed once per padded
(H, W) with the numpy functions and kept on the device.  The cached
pipeline's photometric jitter draws from the Learner's device generator,
not ``jax.random``.  ``enable_device_cache`` is split in two: the host
decode (cv2) and :meth:`ObjectDetectionLearner.install_device_cache`,
which takes a decoded uint8 canvas.  ``retinanet_coco_weights`` renames
the reference's torch state dict into the port's model.  cv2 is imported
inside the functions that use it (the card's machine has none).

Not ported yet (ROADMAP Queue 1): ``show_bbox_preds``,
``TransformBBoxShowPreds`` and ``ShowImages`` (matplotlib).
"""

from __future__ import annotations

import copy as _copy
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.applications.vision import (
    COCO_thresholds,
    convert_bbox_list,
    correct_foldername,
    get_AspectRatioScale,
    hw_to_mm,
    open_image,
)
from neuralnetworklibrary_tpu_torch.data.loader import Batch
from neuralnetworklibrary_tpu_torch.data.split import SplitTrainVal
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.nn import resnet as _resnet_mod
from neuralnetworklibrary_tpu_torch.nn.retinanet import (
    DEFAULT_RATIOS,
    DEFAULT_SCALES,
    FPN,
    BoxSubNet,
    generate_anchors,
)
from neuralnetworklibrary_tpu_torch.nn.transformer import resolve_device
from neuralnetworklibrary_tpu_torch.ops.augment import (
    imagenet_stats,
    normalize_batch,
)
from neuralnetworklibrary_tpu_torch.ops.boxes import (
    batched_nms,
    decode_boxes,
    pairwise_iou,
)


# ---------------------------------------------------------------------------
# (1) Transforms (Vision.py:519-612)
# ---------------------------------------------------------------------------

class TransformBBox:
    """Detection transform (Vision.py:519-603): photometric (brightness /
    contrast) and an optional LR flip with the boxes flipped alike, per
    sample on the host.  The per-batch scale and corner jitter are applied
    by the loader's collate (Vision.py:586-589)."""

    def __init__(self, tfm_type, bal_range=(-0.05, 0.05),
                 cont_range=(0.95, 1.05), stats=imagenet_stats,
                 scale_range=(0.8, 1.2), jitter=20):
        self.tfm_type = tfm_type
        self.bal_range = tuple(bal_range) if bal_range else None
        self.cont_range = tuple(cont_range) if cont_range else None
        self.stats = stats
        self.scale_range = tuple(scale_range)
        self.jitter = jitter
        self._rng = np.random.default_rng()
        # a list makes __call__ append (flip, original width) per sample:
        # what TTA_bbox needs to undo each pass
        self.record: Optional[list] = None

    def seed(self, seed):
        """Re-seed the per-sample randomness."""
        self._rng = np.random.default_rng(seed)

    def batch_geometry(self, rng: np.random.Generator):
        """The per-batch (rand_scale, row_jit, col_jit) (Vision.py:547-556)."""
        row_jit = int(rng.integers(0, self.jitter + 1))
        col_jit = int(rng.integers(0, self.jitter + 1))
        rand_scale = float(rng.uniform(*self.scale_range))
        return rand_scale, row_jit, col_jit

    def __call__(self, img: np.ndarray, target):
        """img float32 RGB in [0, 1]; target a bbox list (min-max boxes) or
        0.  Returns (img float32 [0, 1], not normalized; bboxes (n, 4);
        cats (n,))."""
        flip = int(self._rng.integers(0, 2)) if self.tfm_type == "SideOn" else 0
        if self.record is not None:
            self.record.append((flip, img.shape[1]))

        if self.bal_range:
            bal = self._rng.uniform(*self.bal_range)
            cont = self._rng.uniform(*self.cont_range)
            mu = img.mean(axis=(0, 1))
            img = np.clip((img - mu) * cont + bal + mu, 0.0, 1.0)

        if flip:
            img = np.ascontiguousarray(img[:, ::-1])

        if target == 0 or (hasattr(target, "__len__") and len(target) == 0):
            bboxes = np.zeros((0, 4), np.float32)
            cats = np.zeros((0,), np.int32)
        else:
            bboxes, cats = convert_bbox_list(target)
            if flip:
                cols = img.shape[1]
                bboxes = np.stack([cols - bboxes[:, 2], bboxes[:, 1],
                                   cols - bboxes[:, 0], bboxes[:, 3]], axis=1)
        return img.astype(np.float32), bboxes, cats.astype(np.int32)


def get_transforms_bbox(tfm_type, jitter=20, scale_range=(0.8, 1.2)):
    """[tfm_eval, tfm_aug] (Vision.py:605-612)."""
    tfm_eval = TransformBBox("Basic", None, None, jitter=0, scale_range=(1, 1))
    tfm_aug = TransformBBox(tfm_type, jitter=jitter, scale_range=scale_range)
    return [tfm_eval, tfm_aug]


# ---------------------------------------------------------------------------
# (2) Dataset and bucketed loaders (Vision.py:640-812)
# ---------------------------------------------------------------------------

class BBoxDataset:
    """Detection dataset: ``images`` is a list of dicts with keys 'img',
    'target' (bbox list), 'aspect_ratio' and 'scale' (Vision.py:642-699)."""

    def __init__(self, IMG_PATH, images, transform, ds_type):
        self.IMG_PATH = correct_foldername(IMG_PATH)
        self.images = images
        self.transform = transform
        self.target_type = "bbox"
        self.ds_type = ds_type
        self.y = [im["target"] for im in images]

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        im = self.images[idx]
        img = open_image(self.IMG_PATH + im["img"])
        target = 0 if self.ds_type == "test" else im["target"]
        img, bboxes, cats = self.transform(img, target)
        return img, float(im["scale"]), bboxes, cats


def _snap_up(x: int, granularity: int) -> int:
    return int(granularity * np.ceil(x / granularity))


def _pad_u8(stats) -> np.ndarray:
    """The padding colour: the normalization mean in uint8, which
    normalizes to ~0."""
    mean = (np.asarray(stats[0], np.float32) if stats is not None
            else np.zeros(3))
    return (mean * 255.0 + 0.5).astype(np.uint8)


class BBoxDataLoader:
    """Aspect-ratio-bucketed detection loader with static padded shapes
    (the reference's AspectRatioSampler and AspectRatioCollater,
    Vision.py:700-812): resize by scale x rand_scale, corner jitter, pad to
    a multiple of ``granularity`` (capped at ``max_side``) with the pad
    colour, boxes to ``max_objects`` rows of -1.

    Yields Batch(xs=(uint8 NHWC,), y=(bboxes (bs, M, 4), cats (bs, M)),
    mask); ``groups`` lists each batch's dataset indices."""

    def __init__(self, ds: BBoxDataset, bs: int, max_objects: int,
                 shuffle=True, bucket=True, granularity=128,
                 max_side=1536, seed=0, record_geometry=False):
        self.ds, self.bs = ds, bs
        self.max_objects = max(1, int(max_objects))
        self.shuffle = shuffle
        self.granularity = granularity
        self.max_side = max_side
        self.seed = seed
        self.epoch = 0
        self.record_geometry = record_geometry
        self.geometry_log: list = []
        L = len(ds)
        if bucket:
            ars = [ds.images[i]["aspect_ratio"] for i in range(L)]
            order = sorted(range(L), key=lambda i: ars[i])
        else:
            order = list(range(L))
        self.groups = [order[i: i + bs] for i in range(0, L, bs)]

    def __len__(self):
        return len(self.groups)

    def peek(self) -> Batch:
        return self._make_batch(self.groups[0], np.random.default_rng(0))

    def _make_batch(self, idxs, rng) -> Batch:
        import cv2

        n_valid = len(idxs)
        idxs = list(idxs) + [idxs[-1]] * (self.bs - n_valid)
        samples = [self.ds[i] for i in idxs]
        rand_scale, row_jit, col_jit = self.ds.transform.batch_geometry(rng)
        if self.record_geometry:
            self.geometry_log.append((rand_scale, row_jit, col_jit))

        imgs, boxes_list, cats_list = [], [], []
        for img, scale, bboxes, cats in samples:
            s = scale * rand_scale
            rows, cols = img.shape[:2]
            img = cv2.resize(img, (int(cols * s), int(rows * s)))
            if len(bboxes):
                bboxes = bboxes * s
                bboxes = bboxes + np.asarray(
                    [col_jit, row_jit, col_jit, row_jit], np.float32)
            imgs.append(img)
            boxes_list.append(bboxes)
            cats_list.append(cats)

        H = _snap_up(max(im.shape[0] for im in imgs) + row_jit, self.granularity)
        W = _snap_up(max(im.shape[1] for im in imgs) + col_jit, self.granularity)
        H, W = min(H, self.max_side), min(W, self.max_side)
        batch_img = np.broadcast_to(_pad_u8(self.ds.transform.stats),
                                    (self.bs, H, W, 3)).copy()
        for i, im in enumerate(imgs):
            h = min(im.shape[0], H - row_jit)
            w = min(im.shape[1], W - col_jit)
            batch_img[i, row_jit: row_jit + h, col_jit: col_jit + w] = (
                np.clip(im[:h, :w], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)

        M = self.max_objects
        bb = np.full((self.bs, M, 4), -1.0, np.float32)
        cc = np.full((self.bs, M), -1, np.int32)
        for i, (b, c) in enumerate(zip(boxes_list, cats_list)):
            m = min(len(b), M)
            if m:
                # targets must not reach past a canvas cropped by max_side
                bb[i, :m] = np.clip(b[:m], 0, [W, H, W, H])
                cc[i, :m] = c[:m]

        mask = np.zeros(self.bs, np.float32)
        mask[:n_valid] = 1.0
        return Batch(xs=(batch_img,), y=(bb, cc), mask=mask, n_valid=n_valid)

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        groups = list(self.groups)
        if self.shuffle:
            rng.shuffle(groups)
        for g in groups:
            yield self._make_batch(g, rng)
        self.epoch += 1


class CachedBBoxLoader:
    """Index loader over a device-resident canvas cache.

    Yields Batch(xs=(cache rows (bs,) int32, flip (bs,) int32), y=(bb,
    cc), mask); the Learner's pipeline gathers the canvases and flips,
    jitters and normalizes them on the device.  Boxes are in canvas
    coordinates; a flipped row's boxes mirror about the canvas width (the
    flipped canvas holds right-aligned content)."""

    def __init__(self, ds, groups, row_offset, boxes, cats, canvas_w, bs,
                 train, seed=0):
        self.ds = ds
        self.groups = [list(g) for g in groups]
        self.row_offset = row_offset             # ds index + offset = row
        self.boxes, self.cats = boxes, cats      # (N, M, 4), (N, M)
        self.canvas_w = canvas_w
        self.bs, self.train, self.seed = bs, train, seed
        self.epoch = 0

    def __len__(self):
        return len(self.groups)

    def _make_batch(self, g, rng) -> Batch:
        n_valid = len(g)
        idxs = list(g) + [g[-1]] * (self.bs - n_valid)
        rows = np.asarray(idxs, np.int32) + self.row_offset
        flip = (rng.integers(0, 2, self.bs).astype(np.int32)
                if self.train else np.zeros(self.bs, np.int32))
        bb = self.boxes[np.asarray(idxs)].copy()
        cc = self.cats[np.asarray(idxs)].copy()
        W = float(self.canvas_w)
        for i in range(self.bs):
            if flip[i]:
                valid = bb[i, :, 0] >= 0
                x0 = W - bb[i, valid, 2]
                x1 = W - bb[i, valid, 0]
                bb[i, valid, 0], bb[i, valid, 2] = x0, x1
        mask = np.zeros(self.bs, np.float32)
        mask[:n_valid] = 1.0
        return Batch(xs=(rows, flip), y=(bb, cc), mask=mask, n_valid=n_valid)

    def peek(self) -> Batch:
        return self._make_batch(self.groups[0], np.random.default_rng(0))

    def __iter__(self):
        rng = np.random.default_rng((self.seed, self.epoch))
        groups = list(self.groups)
        if self.train:
            rng.shuffle(groups)
        for g in groups:
            yield self._make_batch(g, rng)
        self.epoch += 1


class BBoxDataObj:
    """Detection data object (the bbox mode of ImageDataObj,
    Vision.py:814-899): a batched, aspect-bucketed train loader and batched
    val/test loaders in a fixed order (``predict`` maps rows back to the
    dataset through ``groups``); ``val_bs=1`` gives the reference's bs 1
    evaluation."""

    target_type = "bbox"

    def __init__(self, PATH, categories, bs, transforms, train_images,
                 val_images, test_images=None, train_name="train",
                 val_name="val", test_name=None, granularity=128, seed=0,
                 val_bs=None):
        tfm_eval, tfm_aug = transforms[0], transforms[1]
        self.categories, self.bs = categories, bs
        self.val_bs = val_bs if val_bs is not None else bs
        self.transforms = transforms
        self.granularity = granularity
        self.seed = seed
        PATH = correct_foldername(PATH)
        self.PATH = PATH

        self.max_objects = max(
            [len(im["target"]) for im in train_images + val_images
             if not np.isscalar(im["target"])] + [1])

        self.train_ds = BBoxDataset(PATH + train_name + "/", train_images,
                                    tfm_aug, "train")
        self.val_ds = BBoxDataset(PATH + val_name + "/", val_images, tfm_eval,
                                  "val")
        self.test_ds = (BBoxDataset(PATH + test_name + "/", test_images,
                                    tfm_eval, "test") if test_name else None)
        self._make_loaders()

    def _make_loaders(self):
        g, M = self.granularity, self.max_objects
        self.train_dl = BBoxDataLoader(self.train_ds, self.bs, M, shuffle=True,
                                       granularity=g, seed=self.seed)
        self.val_dl = BBoxDataLoader(self.val_ds, self.val_bs, M,
                                     shuffle=False, bucket=True, granularity=g)
        self.test_dl = (BBoxDataLoader(self.test_ds, self.val_bs, M,
                                       shuffle=False, bucket=True,
                                       granularity=g)
                        if self.test_ds else None)

    @classmethod
    def from_json_bbox(cls, PATH, transforms, bs, train_json="train.json",
                       val_json=None, test_json=None, train_name="train",
                       val_name=None, test_name=None, val_frac=0.2, suffix="",
                       get_ARS=(608, 1216), granularity=128, seed=0,
                       val_bs=None):
        """From COCO/Pascal-format json annotations (Vision.py:1062-1200):
        'images' (id, file_name, and width/height where present),
        'annotations' (image_id, bbox xywh, category_id; ignore/iscrowd
        skipped, Vision.py:1134), 'categories' (id, name).  Each image's
        aspect ratio and scale come from :func:`get_AspectRatioScale`."""
        PATH = correct_foldername(PATH)

        def load(name):
            with open(PATH + name) as f:
                return json.load(f)

        trn = load(train_json)
        cats = trn["categories"]
        categories = {i: cats[i]["name"] for i in range(len(cats))}
        cat2dscat = {i: cats[i]["id"] for i in range(len(cats))}
        dscat2cat = {v: k for k, v in cat2dscat.items()}

        def image_dims(entry, folder):
            if "width" in entry and "height" in entry:
                return entry["height"], entry["width"]
            import cv2

            img = cv2.imread(PATH + folder + "/" + entry["file_name"] + suffix)
            return img.shape[0], img.shape[1]

        def build_images(j, folder):
            images = {}
            for e in j["images"]:
                ID = e["id"]
                rows, cols = image_dims(e, folder)
                ar, scale = get_AspectRatioScale(rows, cols, *get_ARS)
                images[ID] = {"id": ID, "img": e["file_name"] + suffix,
                              "target": [], "aspect_ratio": ar,
                              "scale": scale}
            for ann in j["annotations"]:
                if ann.get("ignore") == 1 or ann.get("iscrowd") == 1:
                    continue
                images[ann["image_id"]]["target"].append(
                    (np.asarray(ann["bbox"], np.float32),
                     dscat2cat[ann["category_id"]]))
            for im in images.values():
                im["target"] = [(hw_to_mm(b), c) for b, c in im["target"]]
            return list(images.values())

        train_images = build_images(trn, train_name)
        if val_json:
            if not val_name:
                raise ValueError("val_json requires val_name (the folder "
                                 "holding the validation images)")
            val_images = build_images(load(val_json), val_name)
        else:
            train_images, val_images = SplitTrainVal(
                train_images, val_frac=val_frac, seed=seed)
            val_name = train_name

        test_images = None
        if test_name and test_json:
            test_images = build_images(load(test_json), test_name)
        elif test_name:
            import cv2

            test_images = []
            for fn in sorted(os.listdir(PATH + test_name)):
                if fn.startswith("._"):
                    continue
                img = cv2.imread(PATH + test_name + "/" + fn)
                ar, scale = get_AspectRatioScale(img.shape[0], img.shape[1],
                                                 *get_ARS)
                test_images.append({"img": fn, "target": 0,
                                    "aspect_ratio": ar, "scale": scale})

        data = cls(PATH, categories, bs, transforms, train_images, val_images,
                   test_images, train_name, val_name, test_name,
                   granularity=granularity, seed=seed, val_bs=val_bs)
        data.cat2dscat = cat2dscat
        return data


# ---------------------------------------------------------------------------
# (3) ObjectDetectionNet (Vision.py:1382-1471)
# ---------------------------------------------------------------------------

_BACKBONES = {"resnet18": _resnet_mod.resnet18, "resnet34": _resnet_mod.resnet34,
              "resnet50": _resnet_mod.resnet50,
              "resnet101": _resnet_mod.resnet101,
              "resnet152": _resnet_mod.resnet152}


class ObjectDetectionNet(nn.Module):
    """RetinaNet: a ResNet body (``return_pyramid``) + FPN + the shared box
    subnets.  Layer groups [body, fpn, head (classifier + regressor)];
    ``freeze()`` trains the subnets only.  ``forward`` takes NHWC images
    and returns (anchors (N, 4), reg (B, N, 4), clas (B, N, classes)), as
    the reference does (Vision.py:1446-1471); the anchors are those of the
    padded input shape, computed once per shape and device."""

    head_prefixes = ("classifier", "regressor")
    layer_group_prefixes = (("body",), ("fpn",), ("classifier", "regressor"))

    def __init__(self, num_classes: int, backbone: str = "resnet50",
                 ratios=DEFAULT_RATIOS, scales=DEFAULT_SCALES,
                 prior: float = 0.01, feature_size: int = 256,
                 use_bn: bool = False, drop: Optional[tuple] = None,
                 device=None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes, self.backbone = num_classes, backbone
        self.ratios, self.scales = tuple(ratios), tuple(scales)
        self.body = _BACKBONES[backbone](return_pyramid=True, device=dev)
        self.fpn = FPN(self.body.pyramid_channels, feature_size, device=dev)
        A = len(self.ratios) * len(self.scales)
        self.regressor = BoxSubNet(A, 4, feature_size, use_bn, drop,
                                   device=dev)
        self.classifier = BoxSubNet(A, num_classes, feature_size, use_bn,
                                    drop, prior=prior, sigmoid_out=True,
                                    device=dev)
        self.to(memory_format=torch.channels_last)
        self._anchors: dict = {}

    def anchors_for(self, hw, device) -> torch.Tensor:
        """The (N, 4) anchors of a padded (H, W) input, on ``device``."""
        key = (int(hw[0]), int(hw[1]), str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(generate_anchors(
                key[:2], self.ratios, self.scales)).to(device)
        return self._anchors[key]

    def forward(self, x, train: bool = False,
                bn_frozen: Optional[str] = None):
        body_bn_train = False if bn_frozen in ("all", "non_head") else None
        head_bn_train = False if bn_frozen == "all" else None
        c3, c4, c5 = self.body(x.permute(0, 3, 1, 2), train=train,
                               bn_train=body_bn_train)
        feats = self.fpn(c3, c4, c5)
        reg = torch.cat([self.regressor(f, train, head_bn_train)
                         for f in feats], 1)
        clas = torch.cat([self.classifier(f, train, head_bn_train)
                          for f in feats], 1)
        return self.anchors_for(x.shape[1:3], x.device), reg, clas


# ---------------------------------------------------------------------------
# (4) SSD loss: matching, focal, smooth-L1 (Vision.py:1474-1664), batched
#     over any leading dims
# ---------------------------------------------------------------------------

def match_anchors_objects(objects, anchors, pos_thresh=0.5, neg_thresh=0.4):
    """Match each anchor to its best-overlap object (Vision.py:1474-1512).

    objects (..., M, 4) min-max; -1 rows have zero area, so IoU 0 with
    every anchor, and are never matched.  Returns (pos (..., N) bool, neg
    bool, matches (..., N) with -1 where unmatched); ties go to the first
    object."""
    jac = pairwise_iou(objects, anchors)
    max_values = jac.amax(dim=-2)
    max_idxs = jac.argmax(dim=-2)
    pos = max_values > pos_thresh
    neg = max_values < neg_thresh
    matches = torch.where(pos, max_idxs, torch.full_like(max_idxs, -1))
    return pos, neg, matches


def focal_loss_retina(pred, target, well_mask=None, alpha=0.25, gamma=2.0):
    """Focal loss over sigmoid probabilities (Vision.py:1513-1531), summed
    over (N, C) and divided by the positive count (at least 1);
    ``well_mask`` (..., N) drops the undetermined anchors."""
    p = pred.clamp(1e-4, 1.0 - 1e-4)
    t = target
    pt = p * t + (1 - p) * (1 - t)
    w = (alpha * t + (1 - alpha) * (1 - t)) * (1 - pt) ** gamma
    losses = -w * (t * torch.log(p) + (1 - t) * torch.log(1 - p))
    if well_mask is not None:
        losses = losses * well_mask[..., None]
        t = t * well_mask[..., None]
    return losses.sum((-2, -1)) / t.sum((-2, -1)).clamp(min=1.0)


def smoothL1_loss_retina(anchs, pred_shift, target, pos_mask=None):
    """Smooth-L1 on the normalized (dx, dy, dw, dh) offsets
    (Vision.py:1532-1566); with ``pos_mask`` (..., N) the mean runs over
    the positive anchors, and is 0 where there is none."""
    aw = anchs[:, 2] - anchs[:, 0]
    ah = anchs[:, 3] - anchs[:, 1]
    acx = anchs[:, 0] + 0.5 * aw
    acy = anchs[:, 1] + 0.5 * ah

    tw = (target[..., 2] - target[..., 0]).clamp(min=1.0)
    th = (target[..., 3] - target[..., 1]).clamp(min=1.0)
    tcx = target[..., 0] + 0.5 * (target[..., 2] - target[..., 0])
    tcy = target[..., 1] + 0.5 * (target[..., 3] - target[..., 1])

    dx = (tcx - acx) / aw
    dy = (tcy - acy) / ah
    dw = torch.log(tw / aw)
    dh = torch.log(th / ah)
    true_shift = torch.stack([dx, dy, dw, dh], dim=-1) / torch.tensor(
        [0.1, 0.1, 0.2, 0.2], device=anchs.device)

    diff = (true_shift - pred_shift).abs()
    losses = torch.where(diff < 1 / 9, 0.5 * 9 * diff ** 2, diff - 0.5 / 9)
    if pos_mask is None:
        return losses.mean()
    losses = losses * pos_mask[..., None]
    n = pos_mask.sum(-1) * 4
    return torch.where(n > 0, losses.sum((-2, -1)) / n.clamp(min=1.0),
                       torch.zeros_like(n))


def ssd1(anchors, bboxes, cats, reg, clas, alpha=0.25, gamma=2.0):
    """SSD components (Vision.py:1568-1605) of one image (bboxes (M, 4),
    cats (M,), reg (N, 4), clas (N, C)) or a batch of them (a leading B):
    (reg_loss, clas_loss), each () or (B,).  -1 rows are the mask."""
    num_classes = clas.shape[-1]
    pos, neg, matches = match_anchors_objects(bboxes, anchors)
    well = (pos | neg).to(torch.float32)
    posf = pos.to(torch.float32)

    obj_idxs = matches.clamp(min=0)
    cat_idxs = torch.gather(cats.long(), -1, obj_idxs).clamp(min=0)
    cat_targ = F.one_hot(cat_idxs, num_classes).to(torch.float32) \
        * posf[..., None]

    clas_loss = focal_loss_retina(clas, cat_targ, well, alpha, gamma)
    box_targ = torch.gather(bboxes, -2, obj_idxs[..., None].expand(
        *obj_idxs.shape, 4))
    reg_loss = smoothL1_loss_retina(anchors, reg, box_targ, posf)
    return reg_loss, clas_loss


class SSD_loss:
    """Weighted focal + smooth-L1 detection loss (Vision.py:1607-1644):
    (1 - beta) x reg + beta x clas, each averaged over the valid rows.  The
    reference's per-image loop is one batched computation here."""

    def __init__(self, beta=0.5, alpha=0.25, gamma=2.0):
        self.beta, self.alpha, self.gamma = beta, alpha, gamma

    def components(self, activ, target, mask=None):
        anchors, reg, clas = activ
        BBoxes, Cats = target
        reg_l, clas_l = ssd1(anchors, BBoxes, Cats, reg, clas, self.alpha,
                             self.gamma)
        if mask is None:
            return reg_l.mean(), clas_l.mean()
        w = mask.to(torch.float32)
        n = w.sum().clamp(min=1.0)
        return (reg_l * w).sum() / n, (clas_l * w).sum() / n

    def __call__(self, activ, target, mask=None):
        reg_l, clas_l = self.components(activ, target, mask)
        return (1 - self.beta) * reg_l + self.beta * clas_l


class SSD_RegLoss:
    """Metric: the smooth-L1 component (Vision.py:1646-1654)."""

    def __init__(self, loss_func: SSD_loss):
        self.loss_func = loss_func

    def __call__(self, y_pred, y, mask=None):
        return self.loss_func.components(y_pred, y, mask)[0]


class SSD_ClasLoss:
    """Metric: the focal component (Vision.py:1656-1664)."""

    def __init__(self, loss_func: SSD_loss):
        self.loss_func = loss_func

    def __call__(self, y_pred, y, mask=None):
        return self.loss_func.components(y_pred, y, mask)[1]


class ComputeMaxOverlaps:
    """Metric: the mean over objects of each object's best anchor IoU, over
    the images that hold an object (Vision.py:1666-1694)."""

    def __call__(self, y_pred, y, mask=None):
        anchors = y_pred[0]
        BBoxes, Cats = y
        jac = pairwise_iou(BBoxes, anchors)
        best = jac.amax(dim=-1)
        valid = (Cats >= 0).to(torch.float32)
        n = valid.sum(-1)
        vals = torch.where(n > 0, (best * valid).sum(-1) / n.clamp(min=1.0),
                           torch.zeros_like(n))
        w = (n > 0).to(torch.float32)
        if mask is not None:
            w = w * mask
        return (vals * w).sum() / w.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# (5) Box prediction: device decode + NMS, host prune passes
#     (retinanet.py:498-813)
# ---------------------------------------------------------------------------

@torch.no_grad()
def _predict_device(reg, clas, anchors, img_hw, thresh=0.05, max_overlap=0.5,
                    top_k=1000, out_k=20, return_counts=False):
    """Batched decode + threshold + greedy NMS on the device."""
    boxes = decode_boxes(reg, anchors, img_hw)
    scores = clas.amax(dim=-1)
    classes = clas.argmax(dim=-1)
    pos_area = (((boxes[..., 2] - boxes[..., 0]) > 0)
                & ((boxes[..., 3] - boxes[..., 1]) > 0))
    s = torch.where((scores > thresh) & pos_area, scores,
                    torch.zeros_like(scores))
    return batched_nms(boxes, classes, s, max_overlap=max_overlap,
                       top_k=top_k, out_k=out_k, return_counts=return_counts)


def _fetch(b, c, s):
    """The NMS output to the host in one copy: (boxes (B, k, 4) float32,
    classes (B, k) int32, scores (B, k) float32)."""
    packed = torch.cat([b, c[..., None].to(b.dtype), s[..., None]], -1)
    out = packed.cpu().numpy()
    return out[..., :4], out[..., 4].astype(np.int32), out[..., 5]


def _np_iou(a, b):
    """pairwise_iou in numpy float32."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (np.clip(a[:, 2] - a[:, 0], 0.0, None)
              * np.clip(a[:, 3] - a[:, 1], 0.0, None))
    area_b = (np.clip(b[:, 2] - b[:, 0], 0.0, None)
              * np.clip(b[:, 3] - b[:, 1], 0.0, None))
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0),
                    np.float32(0.0))


def nms_post_passes(boxes, classes, scores, rel_thresh=None, inc=None,
                    dup=None, max_boxes=20, print_it=False):
    """Host prune modes on the NMS survivors (retinanet.py:613-704).

    boxes (k, 4), classes (k,), scores (k,) numpy, by descending score.
    Returns (list of boxes, list of int classes, list of float scores).
    ``print_it`` prints the box count after each stage (retinanet.py:
    578-708)."""
    def _trace(stage):
        if print_it:
            print(f"after {stage}")
            print(len(scores))

    keep = np.ones(len(scores), bool)

    if rel_thresh is not None and len(scores):
        r1, r2 = rel_thresh
        keep &= scores >= r1 * scores[0]
        # j dies if an earlier same-class i has score[j] < r2 * score[i]
        for i in range(len(scores) - 1):
            if not keep[i]:
                continue
            for j in range(i + 1, len(scores)):
                if keep[j] and classes[j] == classes[i] \
                        and scores[j] < r2 * scores[i]:
                    keep[j] = False
        boxes, classes, scores = boxes[keep], classes[keep], scores[keep]
        keep = np.ones(len(scores), bool)
    _trace("relative threshold")

    if inc is not None and len(scores):
        inc_thresh, inc_classes = inc
        L = len(scores)
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        tl = np.maximum(boxes[:, None, :2], boxes[None, :, :2])
        br = np.minimum(boxes[:, None, 2:], boxes[None, :, 2:])
        wh = np.clip(br - tl, 0, None)
        inter = wh[..., 0] * wh[..., 1]
        # ratios[i, j] = the share of box j inside box i, same class only
        ratios = inter / np.maximum(areas[None, :], 1e-9)
        same = classes[:, None] == classes[None, :]
        inclusions = ((ratios * same) > inc_thresh).astype(int) \
            - np.eye(L, dtype=int)
        big = inclusions * ((areas[None, :]
                             / np.maximum(areas[:, None], 1e-9)) > 0.25)
        single = list(np.where(big.sum(axis=1) == 1)[0])
        single = [i for i in single if int(classes[i]) not in inc_classes]
        partners = [int(np.argmax(big[i])) for i in single]
        single = list(set(single) - set(partners))
        for i in single:
            j = int(np.argmax(big[i]))
            if scores[i] < 0.75 * scores[j]:
                keep[i] = False
            elif scores[j] < 0.75 * scores[i]:
                keep[j] = False
        boxes, classes, scores = boxes[keep], classes[keep], scores[keep]
        keep = np.ones(len(scores), bool)
    _trace("filtering single inclusions")

    if dup is not None and len(scores):
        dup_thresh, dup_pairs = dup
        changed = True
        while changed:
            changed = False
            alive = np.where(keep)[0]
            b = boxes[alive]
            tl = np.maximum(b[:, None, :2], b[None, :, :2])
            br = np.minimum(b[:, None, 2:], b[None, :, 2:])
            wh = np.clip(br - tl, 0, None)
            inter = wh[..., 0] * wh[..., 1]
            ar = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
            union = ar[:, None] + ar[None, :] - inter
            jac = np.where(union > 0, inter / union, 0)
            for a in range(len(alive) - 1):
                i = alive[a]
                for bj in range(a + 1, len(alive)):
                    j = alive[bj]
                    if (jac[a, bj] > dup_thresh
                            and (int(classes[i]), int(classes[j])) in dup_pairs
                            and scores[j] < 0.75 * scores[i]):
                        keep[j] = False
                        changed = True
                        break
                if changed:
                    break
        boxes, classes, scores = boxes[keep], classes[keep], scores[keep]
    _trace("filtering duplicate predictions of different classes")

    boxes, classes, scores = (boxes[:max_boxes], classes[:max_boxes],
                              scores[:max_boxes])
    _trace("restrict to max_boxes")
    return list(boxes), [int(c) for c in classes], [float(s) for s in scores]


class BBoxPredictor:
    """Decode + NMS front end (retinanet.py:713-813): the device decodes,
    thresholds and suppresses the whole batch; the host applies the prune
    passes and makes per-image lists."""

    def __init__(self, mean=(0.0, 0.0, 0.0, 0.0), std=(0.1, 0.1, 0.2, 0.2)):
        self.mean, self.std = mean, std

    def __call__(self, img_hw, reg, clas, anchors, thresh=0.05,
                 max_overlap=0.5, rel_thresh=None, top_k=1000, max_boxes=20,
                 dup=None, inc=None, print_it=False):
        post = rel_thresh is not None or dup is not None or inc is not None
        out_k = max(100, max_boxes) if post else max_boxes
        out = _predict_device(reg, clas, anchors,
                              tuple(int(d) for d in img_hw), thresh=thresh,
                              max_overlap=max_overlap, top_k=top_k,
                              out_k=out_k, return_counts=print_it)
        b, c, s = _fetch(*out[:3])
        counts = out[3].cpu().numpy() if print_it else None
        PredBoxes, PredClasses, ConfScores = [], [], []
        for i in range(b.shape[0]):
            valid = s[i] > 0
            bi, ci, si = b[i][valid], c[i][valid], s[i][valid]
            if print_it:
                print("after top_k")
                print(int(counts[i][0]))
                print("after non-max-supress")
                print(int(counts[i][1]))
            bi, ci, si = nms_post_passes(bi, ci, si, rel_thresh, inc, dup,
                                         max_boxes, print_it=print_it)
            if print_it:
                print("")
            PredBoxes.append(bi)
            PredClasses.append(ci)
            ConfScores.append(si)
        return PredBoxes, PredClasses, ConfScores


# ---------------------------------------------------------------------------
# (6) mAP (Vision.py:1696-1800), numpy on the host
# ---------------------------------------------------------------------------

def mAP1(targs, preds, scores, thresh):
    """AP of one (category, IoU threshold) (Vision.py:1696-1748): greedy
    best-overlap assignment (at most one correct prediction per target),
    then the sum of the flipped-cummax-smoothed precision at each hit over
    the number of targets."""
    N = len(targs)
    IsCorrect, Scores = [], []
    for i in range(N):
        is_correct = [0] * len(preds[i])
        if len(preds[i]) and len(targs[i]):
            t = np.asarray(targs[i], np.float32).reshape(-1, 4)
            p = np.asarray(preds[i], np.float32).reshape(-1, 4)
            jac = _np_iou(t, p)
            max_overlaps = jac.max(axis=1)
            max_idxs = jac.argmax(axis=1)
            for j, idx in enumerate(max_idxs):
                if max_overlaps[j] > thresh:
                    is_correct[int(idx)] = 1
        IsCorrect += is_correct
        Scores += list(scores[i])

    ntrue = sum(len(t) for t in targs)
    if ntrue == 0 or len(Scores) == 0:
        return 0.0
    # the reference sorts (score, is_correct) pairs descending
    # (Vision.py:1731): a hit ranks ahead of a miss at equal score
    IsCorrect = np.asarray(IsCorrect)
    order = np.lexsort((-IsCorrect, -np.asarray(Scores)))
    IsCorrect = IsCorrect[order]
    L = len(IsCorrect)
    tp = np.cumsum(IsCorrect)
    precision = tp / np.arange(1, L + 1)
    prec_max = np.flip(np.maximum.accumulate(np.flip(precision)))
    prec_smoothed = prec_max[IsCorrect.nonzero()[0]]
    return float(np.sum(prec_smoothed) / ntrue)


def mAP(predictions, targets, categories, thresholds=COCO_thresholds,
        verbose=False):
    """mAP averaged over categories x IoU thresholds (Vision.py:1749-1800).
    predictions: per image [pred_boxes, pred_classes, conf_scores];
    targets: per image bbox lists [(box_minmax, cat), ...]."""
    N, C = len(predictions), len(categories)
    targs = [[[] for _ in range(N)] for _ in range(C)]
    preds = [[[] for _ in range(N)] for _ in range(C)]
    scores = [[[] for _ in range(N)] for _ in range(C)]

    for i in range(N):
        pred_boxes, pred_classes, conf_scores = predictions[i]
        for j in range(len(pred_boxes)):
            c = int(pred_classes[j])
            preds[c][i].append(pred_boxes[j])
            scores[c][i].append(conf_scores[j])
        for b, c in targets[i]:
            targs[int(c)][i].append(b)

    vals = np.zeros((len(thresholds), C))
    for c in range(C):
        for j, thresh in enumerate(thresholds):
            vals[j, c] = mAP1(targs[c], preds[c], scores[c], thresh)
            if verbose:
                print(f"cat={c}:{categories[c]} thresh={thresh} "
                      f"AP={vals[j, c]:.4f}")
    return float(np.mean(vals))


# ---------------------------------------------------------------------------
# (7) ObjectDetectionLearner (Vision.py:1805, bbox methods :1928-2177)
# ---------------------------------------------------------------------------

def photometric(x, bal, cont):
    """Brightness / contrast jitter of float NHWC images in [0, 1] by
    per-row factors bal, cont (B, 1, 1, 1): clip((x - mu) * cont + bal +
    mu) with mu each row's channel means (Vision.py:560-567)."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    return ((x - mu) * cont + bal + mu).clamp(0.0, 1.0)


def gather_canvas(cache, rows, flip):
    """Rows of a uint8 (N, H, W, 3) canvas cache -> float [0, 1], each row
    mirrored left-right where ``flip`` is set."""
    x = cache.index_select(0, rows.long()).to(torch.float32) / 255.0
    return torch.where(flip.bool()[:, None, None, None], x.flip(2), x)


def canvas_targets(images, max_objects, canvas_hw):
    """The boxes of image dicts on the canvas: each image's target scaled
    by its 'scale' and clipped to the (H, W) canvas -> (L, M, 4) boxes and
    (L, M) cats, -1 padded."""
    H, W = canvas_hw
    M = max_objects
    bb = np.full((len(images), M, 4), -1.0, np.float32)
    cc = np.full((len(images), M), -1, np.int32)
    for i, im in enumerate(images):
        t = im["target"]
        if t == 0 or (hasattr(t, "__len__") and len(t) == 0):
            continue
        b, c = convert_bbox_list(t)
        m = min(len(b), M)
        bb[i, :m] = np.clip(b[:m] * float(im["scale"]), 0, [W, H, W, H])
        cc[i, :m] = c[:m]
    return bb, cc


def decode_canvas(datasets, granularity, stats):
    """Decode (cv2) every image of ``datasets`` in order, scale it by its
    'scale', and place it top-left on one uint8 (N, H, W, 3) canvas of the
    pad colour, H and W the largest scaled sides snapped up to
    ``granularity``."""
    import cv2

    decoded = []
    for d in datasets:
        for im in d.images:
            img = open_image(d.IMG_PATH + im["img"])
            s = float(im["scale"])
            r, c = img.shape[:2]
            decoded.append(cv2.resize(img, (int(c * s), int(r * s))))
    Hc = _snap_up(max(im.shape[0] for im in decoded), granularity)
    Wc = _snap_up(max(im.shape[1] for im in decoded), granularity)
    imgs = np.broadcast_to(_pad_u8(stats), (len(decoded), Hc, Wc, 3)).copy()
    for i, im in enumerate(decoded):
        imgs[i, :im.shape[0], :im.shape[1]] = (
            np.clip(im, 0, 1) * 255.0 + 0.5).astype(np.uint8)
    return imgs


class ObjectDetectionLearner(Learner):
    """Learner for detection: the SSD loss by default, uint8 batches
    normalized on the device, bf16 autocast by default (the loss, the
    decode and the NMS in float32), predict with on-device NMS, mAP and
    COCO evaluation."""

    def __init__(self, PATH, data, model, optimizer="default",
                 loss_func="default", use_moving_avg=True, seed=0,
                 compute_dtype="bfloat16", **learner_kwargs):
        if loss_func == "default":
            loss_func = SSD_loss()
        stats = data.transforms[0].stats

        def _pipeline(generator, xs, train):
            return (normalize_batch(xs[0], stats),) + tuple(xs[1:])

        super().__init__(PATH, data, model, optimizer, loss_func,
                         use_moving_avg, seed=seed,
                         compute_dtype=compute_dtype,
                         input_pipeline=_pipeline, **learner_kwargs)
        self.predictor = BBoxPredictor()

    # ------------------------------------------------ the device cache

    def enable_device_cache(self, include_val: bool = False):
        """Decode (cv2), scale and pad every train image (and with
        ``include_val`` every val image) once into one uint8 canvas, and
        :meth:`install_device_cache` it.

        As in JAX: the per-batch scale and corner jitter are off; a flip
        mirrors the whole canvas (the content lands right-aligned, its
        boxes mirrored about the canvas width); with ``include_val``,
        predict, compute_mAP, coco_pascal_eval and TTA_bbox run on the
        device over the canvas (framed on the one global canvas, not per
        bucket: ``predict(dl=learner._host_val_dl)`` takes the host
        path)."""
        data = self.data
        sets = [data.train_ds] + ([data.val_ds] if include_val else [])
        imgs = decode_canvas(sets, data.granularity, data.transforms[0].stats)
        return self.install_device_cache(imgs, include_val)

    def install_device_cache(self, imgs: np.ndarray,
                             include_val: bool = False):
        """Put a decoded uint8 (N, Hc, Wc, 3) canvas on the device: rows
        0..len(train)-1 are the train images, then (``include_val``) the
        val images, each scaled by its 'scale' and placed top-left on the
        pad colour.  Replaces the train (and val) loaders by
        :class:`CachedBBoxLoader` and the input pipeline by the cache's:
        gather, flip, photometric jitter (training), normalize.  Raises
        MemoryError where the canvas would take more than 80% of the
        card's free memory."""
        data = self.data
        ds = data.train_ds
        vds = data.val_ds if include_val else None
        n_rows = len(ds.images) + (len(vds.images) if vds else 0)
        if imgs.dtype != np.uint8 or imgs.ndim != 4 or len(imgs) != n_rows:
            raise ValueError(f"install_device_cache takes uint8 (N, H, W, 3) "
                             f"with N = {n_rows}, got {imgs.dtype} "
                             f"{imgs.shape}")
        Hc, Wc = imgs.shape[1:3]
        M = data.max_objects
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            if imgs.nbytes > 0.8 * free:
                raise MemoryError(
                    f"detection device cache would need "
                    f"{imgs.nbytes / 1e9:.2f} GB ({imgs.shape}) but only "
                    f"{free / 1e9:.2f} GB of device memory is free; use the "
                    "host loaders or a smaller max_side/granularity")

        cache = torch.from_numpy(imgs).to(self.device)
        bb_t, cc_t = canvas_targets(ds.images, M, (Hc, Wc))
        data.train_dl = CachedBBoxLoader(
            ds, data.train_dl.groups, 0, bb_t, cc_t, Wc, data.bs, train=True,
            seed=getattr(data, "seed", 0))
        if vds:
            self._host_val_dl = data.val_dl
            bb_v, cc_v = canvas_targets(vds.images, M, (Hc, Wc))
            data.val_dl = CachedBBoxLoader(
                vds, data.val_dl.groups, len(ds.images), bb_v, cc_v, Wc,
                getattr(data, "val_bs", data.bs), train=False)

        stats = data.transforms[0].stats
        tfm_aug = data.transforms[1]
        bal, cont = tfm_aug.bal_range, tfm_aug.cont_range

        def pipeline(generator, xs, train):
            if xs[0].dim() != 1:      # a host batch of pixels
                return (normalize_batch(xs[0], stats),) + tuple(xs[1:])
            x = gather_canvas(cache, xs[0], xs[1])
            if train and bal is not None:
                x = photometric(x, *self._photo_factors(x.shape[0], generator))
            return (normalize_batch(x, stats),)

        self.set_input_pipeline(pipeline)
        self._device_cache_nbytes = imgs.nbytes
        self._det_cache = cache
        self._det_canvas_hw = (Hc, Wc)
        self._det_stats = stats
        self._det_photo = (bal, cont)
        return self

    def _photo_factors(self, B, generator):
        """Per-row (bal, cont) factors, (B, 1, 1, 1) each, drawn uniform in
        the train transform's ranges."""
        bal, cont = self._det_photo
        shape = (B, 1, 1, 1)
        u = torch.rand((2,) + shape, generator=generator,
                       device=self.device)
        return (u[0] * (bal[1] - bal[0]) + bal[0],
                u[1] * (cont[1] - cont[0]) + cont[0])

    @torch.no_grad()
    def _cached_infer(self, rows, flip, thresh, max_overlap, top_k, out_k,
                      photo=False, generator=None):
        """Device-resident inference of one batch: gather canvas rows,
        flip, photometric jitter (``photo``, TTA passes), normalize,
        forward, decode, threshold and NMS; returns the device NMS
        output."""
        x = gather_canvas(self._det_cache, rows, flip)
        if photo and self._det_photo[0] is not None:
            x = photometric(x, *self._photo_factors(x.shape[0], generator))
        x = normalize_batch(x, self._det_stats)
        self.model.eval()
        with self._autocast():
            anchors, reg, clas = self.model(x, **self._model_kwargs(False))
        return _predict_device(reg.float(), clas.float(), anchors,
                               self._det_canvas_hw, thresh=thresh,
                               max_overlap=max_overlap, top_k=top_k,
                               out_k=out_k)

    def _cached_predict_pass(self, dl, thresh, max_overlap, top_k, out_k,
                             flips=None, photo=False, seed=0):
        """One device-resident inference pass over a CachedBBoxLoader.

        flips: None, or an (L,) 0/1 array per dataset index.  Returns per
        dataset index (boxes, classes, scores) numpy in canvas coordinates
        (un-flipped about the canvas width where flipped), each by
        descending score: the NMS output before the prune passes."""
        L = sum(len(g) for g in dl.groups)
        out = [None] * L
        Wc = float(self._det_canvas_hw[1])
        generator = torch.Generator(self.device).manual_seed(seed)
        pending = []
        for g in dl.groups:
            idxs = list(g) + [g[-1]] * (dl.bs - len(g))
            rows = torch.as_tensor(np.asarray(idxs) + dl.row_offset,
                                   device=self.device)
            fl = (np.asarray([flips[i] for i in idxs], np.int32)
                  if flips is not None else np.zeros(dl.bs, np.int32))
            pending.append((g, fl, self._cached_infer(
                rows, torch.as_tensor(fl, device=self.device), thresh,
                max_overlap, top_k, out_k, photo, generator)))
        for g, fl, dev in pending:
            b, c, s = _fetch(*dev)
            for i, ds_idx in enumerate(g):
                bi = b[i]
                if flips is not None and fl[i]:
                    bi = np.stack([Wc - bi[:, 2], bi[:, 1],
                                   Wc - bi[:, 0], bi[:, 3]], axis=1)
                out[ds_idx] = (bi, c[i], s[i])
        return out

    # ------------------------------------------------ prediction

    @torch.no_grad()
    def predict(self, dl="val", thresh=0.05, max_overlap=0.5, rel_thresh=None,
                top_k=1000, max_boxes=20, dup=None, inc=None, rescale=True,
                print_it=False, **_):
        """Detections (Learner.py:286-393, bbox branch): (PredBoxes,
        PredClasses, ConfScores) per image in dataset order, boxes scaled
        back to the original image by 1/scale (Learner.py:378-380)."""
        if isinstance(dl, str):
            if dl == "train":
                # shuffled, bucketed and jittered: rows cannot be mapped
                # back (Learner.py:339-340)
                raise ValueError("bbox predict requires dl in {'val', 'test'}")
            dl = {"val": self.data.val_dl, "test": self.data.test_dl}[dl]
        if isinstance(dl, CachedBBoxLoader):
            post = rel_thresh is not None or dup is not None or inc is not None
            out_k = max(100, max_boxes) if post else max_boxes
            per_ds = self._cached_predict_pass(dl, thresh, max_overlap,
                                               top_k, out_k)
            PredBoxes, PredClasses, ConfScores = [], [], []
            for ds_idx, (b, c, s) in enumerate(per_ds):
                valid = s > 0
                bi, ci, si = nms_post_passes(b[valid], c[valid], s[valid],
                                             rel_thresh, inc, dup, max_boxes,
                                             print_it=print_it)
                if rescale:
                    scale = dl.ds.images[ds_idx]["scale"]
                    bi = [bb / scale for bb in bi]
                PredBoxes.append(bi)
                PredClasses.append(ci)
                ConfScores.append(si)
            return PredBoxes, PredClasses, ConfScores
        # the loader's groups map each batch row to its dataset index;
        # a loader without them gives rows in order
        groups = getattr(dl, "groups", None)
        L = sum(len(g) for g in groups) if groups is not None else None
        PredBoxes: list = [None] * L if L is not None else []
        PredClasses: list = [None] * L if L is not None else []
        ConfScores: list = [None] * L if L is not None else []
        seq = 0
        self.model.eval()
        for j, (batch, (xs, _, _)) in enumerate(self._device_batches(dl)):
            anchors, reg, clas = self._eval_forward(xs)
            img_hw = batch.xs[0].shape[1:3]
            pb, pc, cs = self.predictor(img_hw, reg, clas, anchors, thresh,
                                        max_overlap, rel_thresh, top_k,
                                        max_boxes, dup, inc,
                                        print_it=print_it)
            for i in range(batch.n_valid):
                ds_idx = groups[j][i] if groups is not None else seq
                seq += 1
                boxes = pb[i]
                if rescale:
                    scale = dl.ds.images[ds_idx]["scale"]
                    boxes = [b / scale for b in boxes]
                if groups is not None:
                    PredBoxes[ds_idx] = boxes
                    PredClasses[ds_idx] = pc[i]
                    ConfScores[ds_idx] = cs[i]
                else:
                    PredBoxes.append(boxes)
                    PredClasses.append(pc[i])
                    ConfScores.append(cs[i])
        return PredBoxes, PredClasses, ConfScores

    def compute_mAP(self, predictions=None, thresholds=COCO_thresholds,
                    verbose=False, **predict_kwargs):
        """mAP on the validation set (Vision.py:2123-2140)."""
        if predictions is None:
            pb, pc, cs = self.predict("val", **predict_kwargs)
            predictions = list(zip(pb, pc, cs))
        targets = [im["target"] for im in self.data.val_ds.images]
        return mAP(predictions, targets, self.data.categories, thresholds,
                   verbose)

    @torch.no_grad()
    def TTA_bbox(self, ds_type="val", transforms=None, num_augs=4, thresh=0.05,
                 max_overlap=0.5, rel_thresh=None, top_k=1000, max_boxes=20,
                 dup=None, inc=None):
        """Test-time augmentation (Vision.py:2036-2123): one eval pass and
        ``num_augs`` augmented passes, each pass's boxes mapped back to the
        original image (un-jitter, un-scale, un-flip), concatenated per
        image and merged by one final NMS.  Returns per image [boxes,
        classes, scores]."""
        if ds_type == "val" and isinstance(self.data.val_dl, CachedBBoxLoader):
            # on the device: the eval pass, then passes of random
            # whole-canvas flips and photometric jitter; un-flipping about
            # the canvas width puts every pass in canvas coordinates
            dl = self.data.val_dl
            src = dl.ds
            L = len(src)
            merged = [[[], [], []] for _ in range(L)]
            rng = np.random.default_rng(777)
            for i in range(1 + num_augs):
                flips = rng.integers(0, 2, L) if i > 0 else None
                per_ds = self._cached_predict_pass(
                    dl, thresh, max_overlap, top_k, max_boxes,
                    flips=flips, photo=i > 0, seed=1000 + i)
                for ds_idx, (b, c, s) in enumerate(per_ds):
                    valid = s > 0
                    bi, ci, si = nms_post_passes(
                        b[valid], c[valid], s[valid], rel_thresh, inc, dup,
                        max_boxes)
                    scale = src.images[ds_idx]["scale"]
                    merged[ds_idx][0] += [bb / scale for bb in bi]
                    merged[ds_idx][1] += ci
                    merged[ds_idx][2] += si
            return self._tta_final_nms(merged, L, num_augs, max_boxes,
                                       max_overlap, rel_thresh, inc, dup)

        src = self.data.val_ds if ds_type == "val" else self.data.test_ds
        tfm_eval, tfm_aug = transforms if transforms else self.data.transforms
        L = len(src)
        merged = [[[], [], []] for _ in range(L)]
        self.model.eval()
        for i in range(1 + num_augs):
            tfm = _copy.deepcopy(tfm_eval if i == 0 else tfm_aug)
            tfm.seed(1000 + i)
            tfm.record = []
            ds = BBoxDataset(src.IMG_PATH, src.images, tfm, src.ds_type)
            # tfm.record fills in sample-access order: row k of batch j is
            # record[j * bs + k]
            dl = BBoxDataLoader(ds, self.data.val_bs, self.data.max_objects,
                                shuffle=False, bucket=True,
                                granularity=self.data.granularity,
                                seed=i, record_geometry=True)
            for j, (batch, (xs, _, _)) in enumerate(self._device_batches(dl)):
                anchors, reg, clas = self._eval_forward(xs)
                img_hw = batch.xs[0].shape[1:3]
                pb, pc, cs = self.predictor(img_hw, reg, clas, anchors, thresh,
                                            max_overlap, rel_thresh, top_k,
                                            max_boxes, dup, inc)
                rand_scale, row_jit, col_jit = dl.geometry_log[j]
                # the loader calls the transform bs times a batch (pads
                # included) and may run one batch ahead: the record is a
                # multiple of bs covering batch j
                if not (len(tfm.record) >= (j + 1) * dl.bs
                        and len(tfm.record) % dl.bs == 0):
                    raise RuntimeError(
                        f"transform record count {len(tfm.record)} is not a "
                        f"bs-multiple covering batch {j} (bs={dl.bs}); TTA "
                        "flip records would be misattributed")
                for k in range(batch.n_valid):
                    ds_idx = dl.groups[j][k]
                    boxes, classes, scores = pb[k], pc[k], cs[k]
                    flip, cols = tfm.record[j * dl.bs + k]
                    scale = src.images[ds_idx]["scale"]
                    if len(boxes):
                        b = np.asarray(boxes, np.float32)
                        b = b - np.asarray([col_jit, row_jit, col_jit, row_jit],
                                           np.float32)
                        b = b / (rand_scale * scale)
                        if i > 0 and flip:
                            b = np.stack([cols - b[:, 2], b[:, 1],
                                          cols - b[:, 0], b[:, 3]], axis=1)
                        boxes = list(b)
                    merged[ds_idx][0] += boxes
                    merged[ds_idx][1] += classes
                    merged[ds_idx][2] += scores

        return self._tta_final_nms(merged, L, num_augs, max_boxes,
                                   max_overlap, rel_thresh, inc, dup)

    def _tta_final_nms(self, merged, L, num_augs, max_boxes, max_overlap,
                       rel_thresh, inc, dup):
        """The final NMS over each image's concatenated passes, all images
        in one batched call of one static size."""
        K = (1 + num_augs) * max_boxes
        B = np.zeros((L, K, 4), np.float32)
        C = np.zeros((L, K), np.int64)
        S = np.zeros((L, K), np.float32)
        for j in range(L):
            boxes, classes, scores = merged[j]
            n = len(scores)
            if n:
                B[j, :n] = np.asarray(boxes, np.float32)
                C[j, :n] = classes
                S[j, :n] = scores
        dev = self.device
        b, c, s = _fetch(*batched_nms(
            torch.from_numpy(B).to(dev), torch.from_numpy(C).to(dev),
            torch.from_numpy(S).to(dev), max_overlap=max_overlap, top_k=K,
            out_k=K))
        AllPreds = []
        for j in range(L):
            valid = s[j] > 0
            bb, cc, ss = nms_post_passes(b[j][valid], c[j][valid],
                                         s[j][valid], rel_thresh, inc, dup,
                                         max_boxes)
            AllPreds.append([bb, cc, ss])
        return AllPreds

    def coco_pascal_eval(self, val_json, predictions=None, **predict_kwargs):
        """COCO-style evaluation (Vision.py:2142-2177): write preds.json in
        COCO results format and run the 12-number bbox COCOeval with the
        reference's Pascal 'ignore' handling (``utils.cocoeval``, its IoU
        and matching in C++).  Returns the stats (stats[0] AP@[.5:.95],
        stats[1] AP50)."""
        from neuralnetworklibrary_tpu_torch.utils.cocoeval import (
            COCO,
            COCOeval,
        )

        if predictions is None:
            pb, pc, cs = self.predict("val", **predict_kwargs)
            predictions = list(zip(pb, pc, cs))

        preds, image_ids = [], []
        cat_map = getattr(self.data, "cat2dscat", None)
        for i, (boxes, classes, scores) in enumerate(predictions):
            ID = self.data.val_ds.images[i].get("id", i)
            image_ids.append(ID)
            for box, cat, score in zip(boxes, classes, scores):
                cat_id = cat_map[int(cat)] if cat_map else int(cat)
                preds.append({
                    "image_id": ID, "category_id": cat_id,
                    "score": float(score),
                    "bbox": [float(box[0]), float(box[1]),
                             float(box[2] - box[0]), float(box[3] - box[1])],
                })
        with open(self.PATH + "preds.json", "w") as f:
            json.dump(preds, f, indent=4)

        coco_true = COCO(val_json)
        coco_pred = coco_true.loadRes(preds)
        E = COCOeval(coco_true, coco_pred, "bbox")
        E.params.imgIds = image_ids
        E.evaluate()
        E.accumulate()
        E.summarize()
        return E.stats


def _retinanet_factory(backbone):
    def ctor(num_classes, **kw):
        return ObjectDetectionNet(num_classes, backbone=backbone, **kw)

    ctor.__doc__ = (f"RetinaNet with a {backbone} backbone "
                    "(retinanet.py:390-428's per-depth constructors).")
    ctor.__name__ = f"retinanet{backbone[6:]}"
    return ctor


retinanet18 = _retinanet_factory("resnet18")
retinanet34 = _retinanet_factory("resnet34")
retinanet50 = _retinanet_factory("resnet50")
retinanet101 = _retinanet_factory("resnet101")
retinanet152 = _retinanet_factory("resnet152")


def retinanet(num_classes=80, device=None):
    """RetinaNet-resnet50 (retinanet.py:430-435's architecture); the
    reference's COCO checkpoint loads by :func:`retinanet_coco_weights`."""
    return ObjectDetectionNet(num_classes, backbone="resnet50", device=device)


def _coco_key(key: str) -> Optional[str]:
    """The port's name of a key of the reference's RetinaNet state dict
    (retinanet.py:299-341), or None for a key the model has no place for."""
    parts = key.split(".")
    head, leaf = parts[:-1], parts[-1]
    if head == ["conv1"]:
        return f"body.stem.conv.{leaf}"
    if head == ["bn1"]:
        return f"body.stem.bn.{leaf}"
    if head and head[0].startswith("layer") and len(head) >= 3:
        block = f"body.{head[0]}_{head[1]}"
        if head[2] == "downsample":
            return f"{block}.down.{'conv' if head[3] == '0' else 'bn'}.{leaf}"
        kind, n = head[2][:-1], head[2][-1]
        return f"{block}.b{n}.{'conv' if kind == 'conv' else 'bn'}.{leaf}"
    if head and head[0] == "fpn":
        return key
    for torch_name, port_name in (("regressionModel", "regressor"),
                                  ("classificationModel", "classifier")):
        if head and head[0] == torch_name:
            return ".".join([port_name] + parts[1:])
    return None


def retinanet_coco_weights(coco_state_dict, model=None, device=None):
    """Load the reference's RetinanetPretrainedCOCO.pt state dict (or a
    path to it) into ``model`` (default: ``retinanet(80)``) by renaming:
    ``conv1``/``bn1``/``layerL.i.convN``/``bnN``/``downsample`` -> ``body``,
    ``fpn.P*`` -> ``fpn``, ``regressionModel``/``classificationModel`` ->
    ``regressor``/``classifier``.  Every parameter and BatchNorm statistic
    of the model must be filled; keys without a place are skipped.
    Returns the model."""
    if isinstance(coco_state_dict, str):
        coco_state_dict = torch.load(coco_state_dict, map_location="cpu",
                                     weights_only=True)
    if model is None:
        model = retinanet(80, device=device)
    own = model.state_dict()
    renamed = {}
    for key, val in coco_state_dict.items():
        name = _coco_key(key)
        if name is not None and name in own:
            renamed[name] = torch.as_tensor(np.asarray(val)) \
                if not torch.is_tensor(val) else val
    missing = [k for k in own if k not in renamed
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"the state dict does not fill {missing[:8]} "
                         f"({len(missing)} tensors)")
    model.load_state_dict(renamed, strict=False)
    return model
