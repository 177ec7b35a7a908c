"""Box operations on the device: IoU, decode, batched fixed-size NMS.

Counterpart of ``neuralnetworklibrary_tpu/ops/boxes.py``.  No TPU kernel
runs here (the JAX NMS is ``lax`` code), so these are torch functions on
tensors of any device:

- :func:`pairwise_iou` of min-max boxes, batched over leading dims;
- :func:`decode_boxes`: regression activations + anchors -> clipped
  min-max boxes (retinanet.py:736-744);
- :func:`batched_nms` / :func:`nms_fixed`: greedy class-aware NMS to a
  fixed number of output slots (retinanet.py:590-602), whole batch at once.

The JAX ``nms_fixed`` sweeps the top-k candidates in score order with a
``lax.fori_loop`` of k steps.  Here the same ``alive`` mask comes from a
fixed-point iteration over the whole (B, k) mask: alive[j] = valid[j] and
no alive i < j suppresses j.  Suppression only reaches later candidates,
so the fixed point is unique and is the greedy sweep's result, and after
t sweeps the first t candidates are final: the loop ends when a sweep
changes nothing (at most k sweeps; as many as the longest chain of
suppressions is deep, each with one host sync).  ``lax.top_k`` breaks ties by the lower index;
the stable descending sort used here does the same, which matters for the
many equal scores of a bf16 ``clas``.
"""

from __future__ import annotations

import torch

BOX_MEAN = (0.0, 0.0, 0.0, 0.0)
BOX_STD = (0.1, 0.1, 0.2, 0.2)


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., N, 4) and (..., M, 4) min-max boxes -> (..., N, M);
    degenerate boxes give 0."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]).clamp(min=0.0)
              * (a[..., 3] - a[..., 1]).clamp(min=0.0))
    area_b = ((b[..., 2] - b[..., 0]).clamp(min=0.0)
              * (b[..., 3] - b[..., 1]).clamp(min=0.0))
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / torch.where(union > 0, union, 1.0),
                       torch.zeros_like(inter))


def decode_boxes(reg, anchors, img_hw, mean=BOX_MEAN, std=BOX_STD):
    """Shift anchors by regression activations -> clipped min-max boxes.

    reg (..., N, 4), anchors (N, 4) min-max, img_hw (H, W).  d = reg * std
    + mean; the centre moves by wh * d[:2], wh scales by exp(d[2:]); x is
    clipped to [0, W], y to [0, H]."""
    mean = torch.tensor(mean, dtype=torch.float32, device=reg.device)
    std = torch.tensor(std, dtype=torch.float32, device=reg.device)
    w = anchors[:, 2] - anchors[:, 0]
    h = anchors[:, 3] - anchors[:, 1]
    cx = anchors[:, 0] + 0.5 * w
    cy = anchors[:, 1] + 0.5 * h

    d = reg * std + mean
    px = cx + w * d[..., 0]
    py = cy + h * d[..., 1]
    pw = w * torch.exp(d[..., 2])
    ph = h * torch.exp(d[..., 3])

    H, W = img_hw
    x0 = (px - 0.5 * pw).clamp(min=0.0)
    y0 = (py - 0.5 * ph).clamp(min=0.0)
    x1 = (px + 0.5 * pw).clamp(max=float(W))
    y1 = (py + 0.5 * ph).clamp(max=float(H))
    return torch.stack([x0, y0, x1, y1], dim=-1)


def _top(scores: torch.Tensor, k: int):
    """``lax.top_k`` along the last dim: the k largest, descending, ties
    to the lower index."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# the number of fixed-point sweeps of the last batched_nms call (a counter
# read by chip_smoke.py)
last_sweeps = 0


def batched_nms(boxes, classes, scores, max_overlap=0.5, top_k=1000,
                out_k=20, return_counts=False):
    """Greedy class-aware NMS with a fixed output size, per batch row.

    boxes (B, N, 4), classes (B, N) int, scores (B, N); scores <= 0 mark
    invalid candidates.  Returns (boxes (B, out_k, 4), classes (B, out_k),
    scores (B, out_k)) sorted by descending score, empty slots with score
    0: the top survivor kills same-class boxes of IoU > max_overlap.
    ``return_counts`` appends an int32 (B, 2) of [candidates entering the
    sweep, survivors] (the reference's nms(print_it=True) counts)."""
    global last_sweeps
    N = boxes.shape[1]
    k = min(top_k, N)
    top_scores, idx = _top(scores, k)
    b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
    c = torch.gather(classes, 1, idx)
    valid = top_scores > 0.0

    iou = pairwise_iou(b, b)
    same = c[:, :, None] == c[:, None, :]
    ar = torch.arange(k, device=boxes.device)
    later = ar[None, :] > ar[:, None]
    suppress = ((iou > max_overlap) & same & later).to(torch.float32)

    alive, sweep = valid, 0
    for sweep in range(1, k + 1):
        hit = torch.bmm(alive.to(torch.float32)[:, None, :],
                        suppress)[:, 0] > 0
        new = valid & ~hit
        if torch.equal(new, alive):
            break
        alive = new
    last_sweeps = sweep

    kept = torch.where(alive, top_scores, torch.zeros_like(top_scores))
    out_scores, oidx = _top(kept, min(out_k, k))
    ob = torch.gather(b, 1, oidx[..., None].expand(-1, -1, 4))
    oc = torch.gather(c, 1, oidx)
    if return_counts:
        counts = torch.stack([valid.sum(1), alive.sum(1)], 1).to(torch.int32)
        return ob, oc, out_scores, counts
    return ob, oc, out_scores


def nms_fixed(boxes, classes, scores, max_overlap=0.5, top_k=1000, out_k=20,
              return_counts=False):
    """:func:`batched_nms` of one image: boxes (N, 4), classes (N,),
    scores (N,) -> (out_k, 4), (out_k,), (out_k,) [, counts (2,)]."""
    out = batched_nms(boxes[None], classes[None], scores[None], max_overlap,
                      top_k, out_k, return_counts)
    return tuple(t[0] for t in out)
