"""Carry flax parameters of the JAX package into the port's modules.

The port keeps the flax names as module attribute names, so the mapping is
a renaming: a flax ``Dense`` ``kernel`` (in, out) becomes ``nn.Linear``
``weight`` (out, in), a norm's ``scale`` becomes ``weight``, and every
other leaf (biases, embeddings, sinks, the LSTM's ``w_ih``/``w_hh``/
``b_ih``/``b_hh``, already in the port's layout) keeps its name.  A flax
``carry`` collection (the AWD-LSTM encoder's (h, c)) goes into the
module's buffers of the same names.
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


def _check_names(kind: str, want, got):
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{kind} tree does not fit the model: missing "
                         f"{missing}, extra {extra}")


def load_jax_params(model: torch.nn.Module, tree, carry=None
                    ) -> torch.nn.Module:
    """Fill ``model``'s parameters from a flax params tree (a nested dict of
    arrays, e.g. ``variables["params"]`` converted with ``np.asarray``),
    in place, casting to each parameter's dtype and device.

    ``carry``, a flax ``carry`` collection (e.g. the JAX Learner's
    ``state["carry"]``), replaces the model's buffers of the same names:
    every buffer must be named, and each takes the tree's batch size; the
    other dimensions must agree.

    Raises ValueError on a parameter (or buffer) the tree lacks, a leaf the
    model has no parameter (or buffer) for, or a shape mismatch.  Returns
    the model.
    """
    params = dict(model.named_parameters())
    flat = {}
    for name, arr in _flatten(tree):
        arr = np.asarray(arr)
        if name.endswith(".kernel") and arr.ndim == 2:
            arr = arr.T
        flat[_torch_name(name)] = arr
    _check_names("params", params, flat)
    for name, arr in flat.items():
        if tuple(arr.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: tree shape {tuple(arr.shape)} != "
                             f"model shape {tuple(params[name].shape)}")
    state = {}
    if carry is not None:
        buffers = dict(model.named_buffers())
        state = {name: np.asarray(arr) for name, arr in _flatten(carry)}
        _check_names("carry", buffers, state)
        for name, arr in state.items():
            if arr.shape[1:] != tuple(buffers[name].shape[1:]):
                raise ValueError(f"{name}: carry shape {tuple(arr.shape)} "
                                 f"does not end in the model's "
                                 f"{tuple(buffers[name].shape[1:])}")
    with torch.no_grad():
        for name, arr in flat.items():
            params[name].copy_(torch.from_numpy(
                np.array(arr, dtype=np.float32)))
        for name, arr in state.items():
            head, _, leaf = name.rpartition(".")
            mod = model.get_submodule(head)
            own = getattr(mod, leaf)
            setattr(mod, leaf, torch.from_numpy(np.array(arr)).to(
                own.device, own.dtype))
    return model
