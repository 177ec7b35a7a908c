"""Mask-aware losses.

Counterpart of the parts of ``neuralnetworklibrary_tpu/core/metrics.py``
that LM training and image classification use.  Protocol: ``loss(y_pred, y, mask=None) -> scalar``;
``mask`` (N,) is 1 for the valid rows of a batch padded to its static size
(``data.loader.DataLoader``), so a masked mean with the Learner's lr
rescale reproduces the reference's short-batch update.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def masked_mean(values: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean over all elements, counting only rows where mask is 1."""
    if mask is None:
        return values.mean()
    w = mask.to(values.dtype).reshape(mask.shape + (1,) * (values.ndim - 1))
    w = w.expand(values.shape)
    return (values * w).sum() / torch.clamp(w.sum(), min=1.0)


def cross_entropy_loss(y_pred, y, mask=None):
    """Softmax CE over (N, C) logits vs (N,) int labels (nn.CrossEntropyLoss);
    tuple model outputs unwrap to their first element."""
    if isinstance(y_pred, tuple):
        y_pred = y_pred[0]
    logp = F.log_softmax(y_pred, dim=-1)
    return masked_mean(-logp.gather(-1, y.long()[..., None])[..., 0], mask)


def bce_with_logits_loss(y_pred, y, mask=None):
    """Elementwise sigmoid BCE, mean over all elements
    (nn.BCEWithLogitsLoss), in the stable form max(x, 0) - x*y +
    log1p(exp(-|x|))."""
    y = y.to(y_pred.dtype)
    losses = (torch.clamp(y_pred, min=0.0) - y_pred * y
              + torch.log1p(torch.exp(-y_pred.abs())))
    return masked_mean(losses, mask)


def accuracy(y_pred, y, mask=None):
    """Single-label accuracy: argmax over logits against int labels."""
    correct = (y_pred.argmax(-1) == y).float()
    return masked_mean(correct, mask)


def multi_label_accuracy(y_pred, y, mask=None):
    """Elementwise accuracy of the rounded sigmoids (Learner.py:463-465)."""
    pred = torch.round(torch.sigmoid(y_pred))
    return masked_mean((pred == y.to(pred.dtype)).float(), mask)


def seq_cross_entropy_loss(y_pred, y, mask=None):
    """Token-level CE over (B, T, V) logits vs (B, T) targets (or (N, C)
    vs (N,)); tuple model outputs unwrap to their first element."""
    if isinstance(y_pred, tuple):
        y_pred = y_pred[0]
    logp = F.log_softmax(y_pred, dim=-1)
    return masked_mean(-logp.gather(-1, y.long()[..., None])[..., 0], mask)


# the loss a Learner takes for loss_func="default", by data.target_type
loss_func_dict = {"single_label": cross_entropy_loss,
                  "multi_label": bce_with_logits_loss,
                  "lang_model": seq_cross_entropy_loss}
