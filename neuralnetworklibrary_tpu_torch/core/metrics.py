"""Mask-aware losses and metrics.

Counterpart of ``neuralnetworklibrary_tpu/core/metrics.py`` (the
reference's General/LossesMetrics.py).  Protocol: ``loss(y_pred, y,
mask=None) -> scalar``; ``mask`` (N,) is 1 for the valid rows of a batch
padded to its static size (``data.loader.DataLoader``), so a masked mean
with the Learner's lr rescale reproduces the reference's short-batch
update.  Batch metrics follow the same protocol.  "End metrics" (``AUC``)
see the whole dataset's predictions on the host: ``Learner.evaluate``
reduces each batch with their ``prepare`` and calls them once at the end.

``AUC`` computes the Mann-Whitney statistic with tied ranks averaged in
numpy, which equals sklearn's ``roc_auc_score`` (the JAX package's), ties
included; sklearn is not needed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def masked_mean(values: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean over all elements, counting only rows where mask is 1."""
    if mask is None:
        return values.mean()
    w = mask.to(values.dtype).reshape(mask.shape + (1,) * (values.ndim - 1))
    w = w.expand(values.shape)
    return (values * w).sum() / torch.clamp(w.sum(), min=1.0)


def mse_loss(y_pred, y, mask=None):
    """Mean squared error over all elements (nn.MSELoss)."""
    return masked_mean((y_pred - y.to(y_pred.dtype)).square(), mask)


def cross_entropy_loss(y_pred, y, mask=None):
    """Softmax CE over (N, C) logits vs (N,) int labels (nn.CrossEntropyLoss);
    tuple model outputs unwrap to their first element."""
    if isinstance(y_pred, tuple):
        y_pred = y_pred[0]
    logp = F.log_softmax(y_pred, dim=-1)
    return masked_mean(-logp.gather(-1, y.long()[..., None])[..., 0], mask)


class LabelSmoothingCrossEntropy:
    """Softmax CE with uniform label smoothing: (1 - eps) * NLL + eps *
    mean(-logp) over the classes.  (N, C) or (B, T, V) logits; tuple
    outputs unwrap to their first element."""

    def __init__(self, smoothing: float = 0.1):
        if not 0.0 <= smoothing < 1.0:
            raise ValueError(f"smoothing must be in [0, 1), got {smoothing}")
        self.smoothing = smoothing

    def __call__(self, y_pred, y, mask=None):
        if isinstance(y_pred, tuple):
            y_pred = y_pred[0]
        logp = F.log_softmax(y_pred, dim=-1)
        nll = -logp.gather(-1, y.long()[..., None])[..., 0]
        eps = self.smoothing
        return masked_mean((1.0 - eps) * nll + eps * -logp.mean(-1), mask)


def bce_with_logits_loss(y_pred, y, mask=None):
    """Elementwise sigmoid BCE, mean over all elements
    (nn.BCEWithLogitsLoss), in the stable form max(x, 0) - x*y +
    log1p(exp(-|x|))."""
    y = y.to(y_pred.dtype)
    losses = (torch.clamp(y_pred, min=0.0) - y_pred * y
              + torch.log1p(torch.exp(-y_pred.abs())))
    return masked_mean(losses, mask)


def MSPE_loss(y_pred, y, mask=None):
    """Mean square percentage error (LossesMetrics.py:18)."""
    return masked_mean(((y_pred - y) / y).square(), mask)


def logMSE_loss(y_pred, y, mask=None):
    """MSE of the logs (LossesMetrics.py:25)."""
    return masked_mean((torch.log(y_pred) - torch.log(y)).square(), mask)


def expMSPE_loss(y_pred, y, mask=None):
    """MSPE of exponentiated predictions and targets (LossesMetrics.py:34),
    the Rossmann metric when training on log targets."""
    ep, et = torch.exp(y_pred), torch.exp(y)
    return masked_mean(((ep - et) / et).square(), mask)


def accuracy(y_pred, y, mask=None):
    """Single-label accuracy: argmax over logits against int labels."""
    correct = (y_pred.argmax(-1) == y).float()
    return masked_mean(correct, mask)


def multi_label_accuracy(y_pred, y, mask=None):
    """Elementwise accuracy of the rounded sigmoids (Learner.py:463-465)."""
    pred = torch.round(torch.sigmoid(y_pred))
    return masked_mean((pred == y.to(pred.dtype)).float(), mask)


class fbeta_loss:
    """Thresholded F-beta for multi-label targets (LossesMetrics.py:44-78):
    with ``use_thresh`` the predictions are sigmoid(y_pred) >= threshold;
    the per-sample F-beta is averaged over the batch."""

    def __init__(self, beta, threshold=0.5, use_thresh=True, eps=1e-9):
        self.beta, self.threshold = beta, threshold
        self.use_thresh, self.eps = use_thresh, eps

    def __call__(self, y_pred, y, mask=None):
        beta2 = self.beta ** 2
        if self.use_thresh:
            y_pred = (torch.sigmoid(y_pred) >= self.threshold).float()
        else:
            y_pred = y_pred.float()
        y = y.float()
        tp = (y_pred * y).sum(1)
        p = tp / (y_pred.sum(1) + self.eps)
        r = tp / (y.sum(1) + self.eps)
        return masked_mean((1 + beta2) * p * r / (beta2 * p + r + self.eps),
                           mask)


class kPrecision:
    """precision@k for single-label targets (LossesMetrics.py:80-107): per
    sample 1/(j+1) for the last position j < k at which the true label
    stands in the descending sort of the predictions, else 0."""

    def __init__(self, k):
        self.k = k

    def __call__(self, y_pred, y, mask=None):
        top = y_pred.topk(self.k, dim=-1).indices
        hits = top == y.long()[:, None]
        idxs = torch.arange(self.k, device=y_pred.device)
        last_hit = torch.where(hits, idxs, -1).amax(1)
        per_sample = torch.where(last_hit >= 0, 1.0 / (last_hit + 1.0),
                                 torch.zeros((), device=y_pred.device))
        return masked_mean(per_sample, mask)


class AUC:
    """ROC AUC of a binary classifier (LossesMetrics.py:110-124), an end
    metric.  ``prepare`` reduces a batch on the host to the positive
    class's probability (float32) and an int8 label; the call is the
    Mann-Whitney U over the positives' ranks, tied ranks averaged:
    (sum of positive ranks - n_pos (n_pos + 1) / 2) / (n_pos n_neg), the
    area under the ROC curve with ties counted one half."""

    is_end_metric = True

    def prepare(self, y_pred, y):
        """(N, 2) logits -> ((N,) float32 probability of class 1, (N,)
        int8 labels)."""
        y_pred = np.asarray(y_pred)
        e = np.exp(y_pred - y_pred.max(axis=1, keepdims=True))
        probs = (e / e.sum(axis=1, keepdims=True))[:, 1].astype(np.float32)
        return probs, np.asarray(y).astype(np.int8)

    def __call__(self, y_pred, y):
        y_pred = np.asarray(y_pred)
        if y_pred.ndim == 2:  # called directly on raw logits
            y_pred, y = self.prepare(y_pred, y)
        pos = np.asarray(y) == 1
        n_pos = int(pos.sum())
        n_neg = len(pos) - n_pos
        if n_pos == 0 or n_neg == 0:
            raise ValueError("AUC needs both classes among the targets")
        return float((average_ranks(y_pred)[pos].sum()
                      - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def average_ranks(x) -> np.ndarray:
    """1-based ranks of ``x``, tied values sharing the mean of their ranks
    (scipy's ``rankdata(method='average')``), as float64."""
    _, inverse, counts = np.unique(np.asarray(x), return_inverse=True,
                                   return_counts=True)
    ends = np.cumsum(counts)
    return (ends - (counts - 1) / 2.0)[inverse.reshape(-1)]


# end metrics by name (Learner.py:16)
end_metrics = {"auc": AUC}


def is_end_metric(m) -> bool:
    """A name in :data:`end_metrics`, or an object whose class says
    ``is_end_metric``."""
    if isinstance(m, str):
        return m in end_metrics
    return bool(getattr(m, "is_end_metric", False))


def seq_cross_entropy_loss(y_pred, y, mask=None):
    """Token-level CE over (B, T, V) logits vs (B, T) targets (or (N, C)
    vs (N,)); tuple model outputs unwrap to their first element."""
    if isinstance(y_pred, tuple):
        y_pred = y_pred[0]
    logp = F.log_softmax(y_pred, dim=-1)
    return masked_mean(-logp.gather(-1, y.long()[..., None])[..., 0], mask)


# the loss a Learner takes for loss_func="default", by data.target_type
loss_func_dict = {"cont": mse_loss,
                  "cat": cross_entropy_loss,
                  "single_label": cross_entropy_loss,
                  "multi_label": bce_with_logits_loss,
                  "text_classify": cross_entropy_loss,
                  "lang_model": seq_cross_entropy_loss}
