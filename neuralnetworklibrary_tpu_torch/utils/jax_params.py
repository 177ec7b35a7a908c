"""Carry flax parameters of the JAX package into the port's modules.

The port keeps the flax names as module attribute names, so the mapping is
a renaming: a flax ``Dense`` ``kernel`` (in, out) becomes ``nn.Linear``
``weight`` (out, in), a norm's ``scale`` becomes ``weight``, and every
other leaf (biases, embeddings, sinks) keeps its name.
"""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, name + ".")
        else:
            yield name, val


def _torch_name(flax_name: str) -> str:
    head, _, leaf = flax_name.rpartition(".")
    leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return f"{head}.{leaf}" if head else leaf


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Fill ``model``'s parameters from a flax params tree (a nested dict of
    arrays, e.g. ``variables["params"]`` converted with ``np.asarray``),
    in place, casting to each parameter's dtype and device.

    Raises ValueError on a parameter the tree lacks, a leaf the model has
    no parameter for, or a shape mismatch.  Returns the model.
    """
    params = dict(model.named_parameters())
    flat = {}
    for name, arr in _flatten(tree):
        arr = np.asarray(arr)
        if name.endswith(".kernel") and arr.ndim == 2:
            arr = arr.T
        flat[_torch_name(name)] = arr
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise ValueError(f"params tree does not fit the model: missing "
                         f"{missing}, extra {extra}")
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: tree shape {tuple(arr.shape)} != "
                             f"model shape {tuple(params[name].shape)}")
    with torch.no_grad():
        for name, arr in flat.items():
            params[name].copy_(torch.from_numpy(
                np.array(arr, dtype=np.float32)))
    return model
