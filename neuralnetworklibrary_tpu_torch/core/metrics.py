"""Mask-aware losses.

Counterpart of the parts of ``neuralnetworklibrary_tpu/core/metrics.py``
that LM training uses.  Protocol: ``loss(y_pred, y, mask=None) -> scalar``;
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


def seq_cross_entropy_loss(y_pred, y, mask=None):
    """Token-level CE over (B, T, V) logits vs (B, T) targets (or (N, C)
    vs (N,)); tuple model outputs unwrap to their first element."""
    if isinstance(y_pred, tuple):
        y_pred = y_pred[0]
    logp = F.log_softmax(y_pred, dim=-1)
    return masked_mean(-logp.gather(-1, y.long()[..., None])[..., 0], mask)


# the loss a Learner takes for loss_func="default", by data.target_type
loss_func_dict = {"lang_model": seq_cross_entropy_loss}
