"""Optimizer with per-layer-group hyperparameters, decoupled weight decay
and global gradient clipping.

Counterpart of ``neuralnetworklibrary_tpu/core/optim.py`` for the ``sgd``
and ``adam`` kinds of its ``opt_dict`` (SGD, SGD_Mom, Adam, Adam2).
:meth:`Optimizer.apply` keeps the JAX order of one step:

1. decoupled weight decay ``p *= 1 - wd*lr`` on trainable parameters (bn
   parameters only with ``bn_wd``);
2. global-norm clipping ``g *= min(1, clip / (norm + 1e-6))`` over the
   trainable gradients;
3. the step: ``buf = mom*buf + g; p -= lr*buf`` (sgd), or Adam with
   bias-corrected moments, an int step count ``t`` per parameter and
   ``eps`` 1e-8 (adam).  The bias corrections and the decay factor are
   computed in float32, as the JAX step computes them.

Unlike the JAX optimizer it updates parameters and state IN PLACE (under
``torch.no_grad``).  The adam kind on a CUDA device runs all three steps
of every trained leaf in one hand-written kernel (``ops/adam.py``), one
launch per layer group and step count; it takes float32 p, g, m and v of
one layout, which :meth:`init` and autograd give, and raises on anything
else.  On the CPU, and for the sgd kind, ``torch._foreach_*`` ops run over
the parameters of one layer group.  Frozen parameters are skipped: their
values, buffers and step counts stay untouched.  State is float32.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Mapping, Sequence

import numpy as np
import torch

from neuralnetworklibrary_tpu_torch.core.partition import Partition
from neuralnetworklibrary_tpu_torch.core.pytree import global_norm
from neuralnetworklibrary_tpu_torch.ops import adam as fused

# Optimizer registry, as opt_dict (Learner.py:16-19) of the JAX package.
opt_dict: dict[str, dict] = {
    "SGD": {"kind": "sgd", "momentum": 0.0},
    "SGD_Mom": {"kind": "sgd", "momentum": 0.9},
    "Adam": {"kind": "adam", "betas": (0.9, 0.999)},
    "Adam2": {"kind": "adam", "betas": (0.9, 0.99)},
}
opt_dict["default"] = opt_dict["SGD_Mom"]
# in the JAX package's opt_dict, not ported yet
NOT_PORTED = ("LAMB", "Lion", "Muon", "Adafactor")


def _f32(x) -> float:
    return float(np.float32(x))


class Optimizer:
    """``Optimizer(opt_func, wd=None, bn_wd=True, clip=None)`` with
    ``opt_func`` a name from :data:`opt_dict`.  It holds no model: the
    state is a dict made by :meth:`init` and passed to :meth:`apply`."""

    def __init__(self, opt_func: str = "default", wd=None, bn_wd: bool = True,
                 clip=None):
        if opt_func in NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {opt_func!r} is not ported yet (ROADMAP Queue 1, "
                f"the rest of core and the Learner)")
        if opt_func not in opt_dict:
            raise ValueError(f"unknown optimizer {opt_func!r}; choose from "
                             f"{list(opt_dict)}")
        cfg = opt_dict[opt_func]
        self.name = opt_func
        self.kind: str = cfg["kind"]
        self.momentum: float = cfg.get("momentum", 0.0)
        self.betas: tuple[float, float] = cfg.get("betas", (0.9, 0.999))
        self.eps: float = 1e-8
        self.wd = wd
        self.bn_wd = bn_wd
        self.clip = clip

    def set_params(self, wd=None, bn_wd=None, clip=None):
        """Update the training-period hyperparameters; unspecified values
        keep their last setting (Learner.init_optimizer, :680-688)."""
        if wd is not None:
            self.wd = wd
        if bn_wd is not None:
            self.bn_wd = bn_wd
        if clip is not None:
            self.clip = clip

    @property
    def uses_momentum(self) -> bool:
        return self.kind == "sgd" and self.momentum != 0.0

    @property
    def uses_betas(self) -> bool:
        return self.kind == "adam"

    def init(self, params: Mapping) -> dict:
        """Fresh state for ``{path: parameter}``: float32 zeros shaped like
        each parameter (``buf``, or ``m``/``v`` and ``t`` = 0)."""
        state = {}
        for path, p in params.items():
            zeros = torch.zeros_like(p, dtype=torch.float32)
            if self.kind == "sgd":
                state[path] = {"buf": zeros}
            else:
                state[path] = {"m": zeros, "v": torch.zeros_like(zeros),
                               "t": 0}
        return state

    @torch.no_grad()
    def apply(self, params: Mapping, grads: Mapping, opt_state: Mapping,
              partition: Partition, trainable: Sequence[bool], lr_groups,
              mom=None, beta1=None, beta2=None, wd_groups=None,
              bn_wd: bool | None = None, clip=None):
        """One step, in place.  ``params``/``grads`` map each path of
        ``partition`` to its tensor (grads of frozen paths may be absent);
        ``lr_groups``/``wd_groups`` hold one float per layer group (already
        including any short-batch rescale); ``mom``/``beta1``/``beta2``
        override the constructor's; ``clip`` None or inf is no clipping."""
        if bn_wd is None:
            bn_wd = self.bn_wd
        mom = self.momentum if mom is None else mom
        b1 = self.betas[0] if beta1 is None else beta1
        b2 = self.betas[1] if beta2 is None else beta2
        by_group = defaultdict(list)
        for i, path in enumerate(partition.paths):
            if trainable[i]:
                by_group[partition.group_idx[i]].append((i, path))
        # the adam kind on the card: all three steps in the kernel's pass
        card = self.kind == "adam" and any(
            params[path].is_cuda for members in by_group.values()
            for _, path in members[:1])
        decays = {}
        if wd_groups is not None:
            for g in by_group:
                decays[g] = _f32(np.float32(1) - np.float32(wd_groups[g])
                                 * np.float32(lr_groups[g]))

        # 1) decoupled weight decay
        if not card:
            for g, members in by_group.items():
                ps = [params[path] for i, path in members
                      if bn_wd or not partition.is_bn[i]]
                if ps and decays.get(g, 1.0) != 1.0:
                    torch._foreach_mul_(ps, decays[g])

        # 2) global grad-norm clipping over the trainable leaves
        scale = None
        if clip is not None and np.isfinite(clip):
            gs = [grads[path] for members in by_group.values()
                  for _, path in members]
            scale = torch.clamp(float(clip) / (global_norm(gs) + 1e-6),
                                max=1.0)
            if not card:
                torch._foreach_mul_(gs, scale)

        # 3) the step, per layer group (and per step count for adam)
        omb1, omb2 = _f32(1.0 - b1), _f32(1.0 - b2)
        b1, b2 = _f32(b1), _f32(b2)
        for g, members in by_group.items():
            lr = _f32(lr_groups[g])
            paths = [path for _, path in members]
            if self.kind == "sgd":
                ps = [params[p] for p in paths]
                bufs = [opt_state[p]["buf"] for p in paths]
                torch._foreach_mul_(bufs, _f32(mom))
                torch._foreach_add_(bufs, [grads[p] for p in paths])
                torch._foreach_add_(ps, bufs, alpha=-lr)
                continue
            by_t = defaultdict(list)
            for i, p in members:
                by_t[opt_state[p]["t"] + 1].append((i, p))
            for t, tmembers in by_t.items():
                tf = np.float32(t)
                bc1 = _f32(np.float32(1) - np.power(np.float32(b1), tf))
                bc2 = _f32(np.float32(1) - np.power(np.float32(b2), tf))
                tpaths = [p for _, p in tmembers]
                ps = [params[p] for p in tpaths]
                gs = [grads[p] for p in tpaths]
                ms = [opt_state[p]["m"] for p in tpaths]
                vs = [opt_state[p]["v"] for p in tpaths]
                if card:
                    fused.adam(
                        ps, gs, ms, vs,
                        [decays.get(g, 1.0) if bn_wd or not partition.is_bn[i]
                         else 1.0 for i, _ in tmembers],
                        lr=lr, b1=b1, omb1=omb1, b2=b2, omb2=omb2, bc1=bc1,
                        bc2=bc2, eps=self.eps, scale=scale)
                else:
                    foreach_adam(ps, gs, ms, vs, lr=lr, b1=b1, omb1=omb1,
                                 b2=b2, omb2=omb2, bc1=bc1, bc2=bc2,
                                 eps=self.eps)
                for p in tpaths:
                    opt_state[p]["t"] = t


def foreach_adam(ps, gs, ms, vs, *, lr, b1, omb1, b2, omb2, bc1, bc2, eps):
    """The Adam step after decay and clipping, in ``torch._foreach_*`` ops
    over lists of tensors, in place: the plain version of the kernel's
    pass (it allocates the bias-corrected moment and the denominator)."""
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=omb1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=omb2)
    m_hat = torch._foreach_div(ms, bc1)
    denom = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    torch._foreach_addcdiv_(ps, m_hat, denom, value=-lr)
