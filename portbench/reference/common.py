"""What every plain reference shares: float32 with TF32 off, the control's
lower precision, a blocked cross-entropy, and the Adam2 training loop
whose readings the benchmark compares with the program's.

Plain PyTorch only: nothing here, and nothing in the family files beside
it, imports the program or JAX.

Precision ``mode``:

- ``"float32"``: every product in float32 on the CUDA cores (TF32 off);
- ``"fp8"``: the control.  Each product's operands are rounded to fp8
  e4m3 (the gradient flowing back to e5m2), each tensor scaled by its
  absolute maximum (448 for e4m3, 57,344 for e5m2), and multiplied in
  float32: the step below the configurations' bfloat16 compute.
"""

from __future__ import annotations

import functools
import math
import time

import torch

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def no_tf32():
    """Float32 products in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _round(x, fmt):
    dtype, top = fmt
    scale = top / x.detach().abs().amax().float().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _round(a, E4M3), _round(b, E4M3)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _round(g, E5M2)
        return qg @ qb.mT, qa.mT @ qg


def matmul(a, b, mode: str):
    """``a @ b`` in the precision ``mode``."""
    if mode == "float32":
        return a @ b
    if mode == "fp8":
        return _Fp8Matmul.apply(a, b)
    raise ValueError(f"unknown precision {mode!r}")


class _Recompute(torch.autograd.Function):
    """``fn(*xs)`` that keeps only its inputs; the backward runs ``fn``
    again with gradients and back-propagates through it.  (A plain
    function: ``torch.utils.checkpoint`` loads the compiler stack on its
    first call, seconds of host time.)"""

    @staticmethod
    def forward(ctx, fn, *xs):
        ctx.fn = fn
        ctx.save_for_backward(*xs)
        with torch.no_grad():
            return fn(*xs)

    @staticmethod
    def backward(ctx, g):
        xs = [x.detach().requires_grad_(x.requires_grad)
              for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.fn(*xs)
        want = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(out, want, g, allow_unused=True))
        return (None, *(next(got) if x.requires_grad else None for x in xs))


def recompute(fn, *xs):
    """``fn(*xs)`` (one tensor out), its intermediates recomputed in the
    backward rather than kept."""
    return _Recompute.apply(fn, *xs)


def _ce_block(mode, h, head, y, w):
    logits = matmul(h, head.mT, mode)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, y[:, None])[:, 0]
    return (nll * w).sum()


def ce_sum(h, head, y, w, mode: str, rows: int = 4096):
    """Sum over the N rows of h (N, D) of w * (the softmax cross-entropy
    of h head^T against y), ``rows`` rows at a time, each block's logits
    recomputed in the backward rather than kept."""
    block = functools.partial(_ce_block, mode)
    total = h.new_zeros(())
    for i in range(0, h.shape[0], rows):
        total = total + recompute(block, h[i:i + rows], head, y[i:i + rows],
                                  w[i:i + rows])
    return total


def causal_attention(q, k, v, starts, mode: str, rows: int = 512):
    """Softmax attention of q (B, T, H, hd) over k, v (B, T, Hkv, hd), query
    head h reading kv head h // (H / Hkv); query t sees key s when
    starts[b, t] <= s <= t (``starts`` (B, T) its document's first
    position).  Scale 1 / sqrt(hd).  ``rows`` queries at a time, each
    block over the keys up to its last query.  Returns (B, T, H * hd)."""
    B, T, H, hd = q.shape
    rep = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    keys = torch.arange(T, device=q.device)
    out = []
    for a in range(0, T, rows):
        b = min(a + rows, T)
        s = matmul(q[:, :, a:b], k[:, :, :b].mT, mode) / math.sqrt(hd)
        t = keys[a:b, None]
        ok = (keys[None, :b] <= t)[None] & (
            keys[None, None, :b] >= starts[:, a:b, None])
        s = s.masked_fill(~ok[:, None], float("-inf"))
        out.append(matmul(torch.softmax(s, -1), v[:, :, :b], mode))
    return torch.cat(out, 2).transpose(1, 2).reshape(B, T, H * hd)


def doc_starts(x, separator):
    """(B, T) long: each position's document start; a document starts
    right after each separator (None: one document a row)."""
    B, T = x.shape
    idx = torch.arange(T, device=x.device).expand(B, T)
    if separator is None:
        return torch.zeros_like(idx)
    sep = torch.zeros_like(x, dtype=torch.bool)
    sep[:, 1:] = x[:, :-1] == separator
    return torch.cummax(torch.where(sep, idx, 0), dim=1).values


def train(params: dict, loss_fn, batches, opt: dict,
          keep_grads: bool = False):
    """Adam2 steps of ``params`` ({name: float32 leaf}), one per batch:
    decoupled weight decay p *= 1 - wd lr, then Adam with bias-corrected
    moments (``opt``: lr, wd, betas, eps).  Returns the readings: each
    step's loss, each leaf's squared gradient norm at step 1, each
    leaf's squared change after the last step (float64 sums), and each
    step's seconds; with ``keep_grads`` also ``grads``, each leaf's step-1
    gradient on the host."""
    b1, b2 = opt["betas"]
    lr, wd, eps = opt["lr"], opt["wd"], opt["eps"]
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grad_sq, step_s, grads = [], {}, [], {}
    for t, batch in enumerate(batches, 1):
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        loss = loss_fn(params, *batch)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if t == 1:
                grad_sq = {k: float(p.grad.double().square().sum())
                           for k, p in params.items()}
                if keep_grads:
                    grads = {k: p.grad.detach().float().cpu()
                             for k, p in params.items()}
            c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for k, p in params.items():
                g = p.grad
                p.mul_(1.0 - wd * lr)
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                p.addcdiv_(m[k] / c1, (v[k] / c2).sqrt_().add_(eps),
                           value=-lr)
        step_s.append(time.perf_counter() - t0)
    change_sq = {k: float((p.detach() - start[k]).double().square().sum())
                 for k, p in params.items()}
    out = {"losses": losses, "grad_sq": grad_sq, "change_sq": change_sq,
           "step_s": step_s}
    if keep_grads:
        out["grads"] = grads
    return out
