"""Parameter helpers the Learner and optimizer use, and ``combine_preds``.

Counterpart of the parts of ``neuralnetworklibrary_tpu/core/pytree.py``
that training and ensembles need.  JAX's flatten/unflatten of a params
pytree become ``nn.Module.named_parameters()``: a parameter's path is its
dotted name split on ".", e.g. ``("block_0", "attn", "qkv", "weight")``.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

Path = tuple[str, ...]


def param_paths(model: torch.nn.Module) -> dict[Path, torch.nn.Parameter]:
    """``{path: parameter}`` in ``named_parameters()`` order."""
    return {tuple(name.split(".")): p for name, p in model.named_parameters()}


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm of all tensors combined, in float32 on their device (the
    quantity torch's ``clip_grad_norm_`` computes)."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(())
    sq = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(sq))


def broadcast_to_groups(x, n_groups: int) -> list:
    """The reference's ``LIST`` (Core.py:78): broadcast a scalar to a
    length-NL list, or validate an existing length-NL list/tuple/array."""
    if isinstance(x, (list, tuple, np.ndarray)) and len(x) == n_groups:
        return list(x)
    if isinstance(x, (list, tuple, np.ndarray)):
        raise ValueError(
            f"per-group value has length {len(x)}, expected {n_groups} "
            f"layer groups")
    return [x] * n_groups


def list_del(lst, del_idxs):
    """Remove elements at the given indices (list_del, Core.py:88-96)."""
    drop = set(int(i) for i in del_idxs)
    return [v for i, v in enumerate(lst) if i not in drop]


def list_mult(lst, c):
    """Multiply every element by a scalar (list_mult, Core.py:98-102)."""
    return [v * c for v in lst]


def outer_mult(lst, vec):
    """[[v * c for c in vec] for v in lst] (outer_mult, Core.py:104-107)."""
    return [[v * c for c in vec] for v in lst]


def linear_space(start, stop, N):
    """N evenly spaced values including both ends (Core.py:109-114)."""
    return list(np.linspace(start, stop, N))


def combine_preds(preds, target_type: str, weights=None):
    """Weighted average of prediction sets (numpy arrays, e.g. from
    ``Learner.predict``), uniform by default (combine_preds, Core.py:277):
    for 'cont' the average; for 'cat', 'single_label' and 'text_classify'
    (average, its argmax); for 'multi_label' (average, its 0/1 rounding)."""
    n = len(preds)
    if weights is None:
        weights = [1.0 / n] * n
    combined = sum(w * p for w, p in zip(weights, preds))
    if target_type == "cont":
        return combined
    if target_type in ("cat", "single_label", "text_classify"):
        return combined, combined.argmax(axis=1)
    if target_type == "multi_label":
        return combined, np.round(combined).astype(int)
    raise ValueError(f"unknown target_type {target_type!r}")
