"""Dropless top-k routing, and the SwiGLU products of a held range of
experts as grouped products, for ``nn.transformer.MoEMLP``.

Counterpart of the dropless path of the JAX package's ``MoEMLP``
(``neuralnetworklibrary_tpu/nn/transformer.py:948-978``, ``eval_dense``):
each token's combine weights are the softmax over its ``k`` largest router
logits (HF ``norm_topk_prob``), and each expert is
``W2 (silu(x W1 + b1) * (x W3 + b3)) + b2``.  The JAX package computes
every expert over every token with einsums that XLA lowers; here a layer
holds experts ``[first, first + E)`` of the router's ``n`` (expert
parallelism: the other chips hold the rest) and computes only their part
of the result, for the tokens routed to them.  No kernel of the JAX
package is replaced: the products are ``torch._grouped_mm`` (CUTLASS's
grouped GEMM on sm_90 in bf16).

Nothing here waits for the device.  The number of assignments an expert
takes is known only on the device, so every buffer has the one static
bound a dropless layer has, all ``N k`` assignments, plus one row that is
never held (below).  The steps:

- route (:func:`moe_route`): the router product, softmax and top-k in
  float32 (``ROUTER_DTYPE``), so bf16 rounding cannot change which
  experts a token picks;
- dispatch: assignments outside the held range get the key ``E``; a
  stable sort by key puts the held ones first, grouped by expert, and
  ``offs`` (E,) int32, the end of each expert's rows, is found on the
  device by a binary search of the sorted keys;
- experts: the gate and up products (one grouped product against the
  two weights side by side, ``h13``) and the down product run over the
  sorted rows.  ``_grouped_mm`` computes the rows below ``offs[-1]`` and
  leaves the rest of its output unwritten.  Biases ride in the products:
  the rows carry a column of ones (and seven of zeros, so that rows stay
  16-byte aligned) and each expert's weight a bias row.  The routing
  weight multiplies the activation before the down product, and its
  column carries b2, so the down product gives each row's weighted
  output;
- combine: each token sums the rows of its held slots in slot order (a
  gather and a sum over k, float32 accumulation, no atomics).  A slot
  that is not held points at the last row, whose key is ``E``, so that no
  product writes it; it is zeroed before the sum.

The backward runs the same steps in reverse, by hand: the gradient rows
are gathered by token, dX and dW are grouped products (dW groups over
rows, so the rows past ``offs[-1]`` are read by none), and dX is summed
back to the tokens as the combine sums.  ``h13`` is kept from the
forward; the gathered rows and the activation are recomputed.

Spans (``utils.tracing``, device): ``moe.router``, ``moe.dispatch``,
``moe.experts``, ``moe.combine`` and the same names with ``.bwd``.
``moe_experts.launches`` counts calls (one per layer and forward);
while tracing is on, the held assignments are summed on the device
(:func:`assignments`), and read only with the counters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neuralnetworklibrary_tpu_torch.utils import tracing

ROUTER_DTYPE = torch.float32
AUG = 8     # the ones column of the bias, and zeros to a 16-byte row


class _Route(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gate, top_k):
        with tracing.span("moe.router", device=True):
            with torch.autocast(x.device.type, enabled=False):
                logits = x.to(ROUTER_DTYPE) @ gate.to(ROUTER_DTYPE)
                vals, idx = logits.topk(top_k, dim=-1)
                w = torch.softmax(vals.float(), dim=-1)
        ctx.save_for_backward(x, gate, idx, w)
        ctx.mark_non_differentiable(idx)
        return w, idx

    @staticmethod
    def backward(ctx, dw, _):
        x, gate, idx, w = ctx.saved_tensors
        dx = dgate = None
        with tracing.span("moe.router.bwd", device=True):
            dvals = w * (dw - (w * dw).sum(-1, keepdim=True))
            dlogits = torch.zeros((x.shape[0], gate.shape[1]),
                                  dtype=torch.float32, device=x.device)
            dlogits.scatter_(1, idx, dvals)
            if ctx.needs_input_grad[0]:
                dx = (dlogits @ gate.float().T).to(x.dtype)
            if ctx.needs_input_grad[1]:
                dgate = (x.float().T @ dlogits).to(gate.dtype)
        return dx, dgate, None


def moe_route(x, gate, top_k: int):
    """(w, idx): each row of x (N, D)'s ``top_k`` experts by the logits
    ``x @ gate`` (gate (D, n)), as (N, k) indices into the n, and their
    combine weights (N, k) float32, the softmax over the selected
    logits."""
    return _Route.apply(x, gate, top_k)


def _dispatch(idx, first: int, E: int):
    """The held assignments' order.  Returns (held (N, k) bool, order
    (N k + 1,) the assignments sorted by held expert, non-held last, tok
    (N k + 1,) each sorted row's token, offs (E,) int32 each expert's end
    row, inv (N, k) each slot's sorted row, N k where not held)."""
    N, k = idx.shape
    rows = N * k
    key = idx - first
    held = (key >= 0) & (key < E)
    key = torch.where(held, key, E).reshape(-1)
    key = torch.cat([key, key.new_full((1,), E)])   # the padding row
    skey, order = torch.sort(key, stable=True)
    offs = torch.searchsorted(
        skey, torch.arange(E, device=idx.device, dtype=skey.dtype),
        right=True).to(torch.int32)
    pos = torch.empty_like(order).scatter_(
        0, order, torch.arange(rows + 1, device=idx.device))
    inv = torch.where(held, pos[:rows].view(N, k), rows)
    tok = (order // k).clamp_max(N - 1)
    return held, order, tok, offs, inv


def _augment(x):
    """x (M, K) -> (M, K + AUG): [x | 1 | 0 ...]."""
    tail = torch.eye(1, AUG, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail.expand(x.shape[0], AUG)], 1)


def _aug_weight(pairs, dtype):
    """[(w (E, K, N_i), b (E, N_i)), ...] -> (E, K + AUG, sum N_i) in
    ``dtype``: the weights side by side, each expert's biases as row K,
    zeros after."""
    E, K, _ = pairs[0][0].shape
    width = sum(w.shape[2] for w, _ in pairs)
    out = torch.empty((E, K + AUG, width), dtype=dtype,
                      device=pairs[0][0].device)
    at = 0
    for w, b in pairs:
        n = w.shape[2]
        out[:, :K, at:at + n].copy_(w)
        out[:, K, at:at + n].copy_(b)
        at += n
    out[:, K + 1:].zero_()
    return out


def _weighted(a, ws):
    """[a * ws | ws | 0 ...] (R, F + AUG): the down product's rows, each
    weighted by its routing weight, with b2's column."""
    R, width = a.shape
    out = torch.empty((R, width + AUG), dtype=a.dtype, device=a.device)
    torch.mul(a, ws[:, None], out=out[:, :width])
    out[:, width].copy_(ws)
    out[:, width + 1:].zero_()
    return out


def _sum_slots(inv, rows):
    """Each token's sum of the rows (R + 1, D) its slots point at
    (``inv`` (N, k)), in slot order; the last row, which slots that are
    not held point at, is zeroed first (no product writes it)."""
    rows[-1].zero_()
    N, k = inv.shape
    return rows.index_select(0, inv.reshape(-1)).view(N, k, -1).sum(1)


class _Experts(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, idx, w1, b1, w3, b3, w2, b2, first, dtype):
        E, D, width = w1.shape
        with torch.autocast(x.device.type, enabled=False):
            with tracing.span("moe.dispatch", device=True):
                held, order, tok, offs, inv = _dispatch(idx, first, E)
                ws = torch.cat([w.reshape(-1), w.new_zeros(1)])[order]
                xs = _augment(x.to(dtype)).index_select(0, tok)
            with tracing.span("moe.experts", device=True):
                w13 = _aug_weight(((w1, b1), (w3, b3)), dtype)
                w2a = _aug_weight(((w2, b2),), dtype)
                h13 = torch._grouped_mm(xs, w13, offs=offs)   # (R + 1, 2 F)
                a = F.silu(h13[:, :width]) * h13[:, width:]
                y = torch._grouped_mm(_weighted(a, ws.to(dtype)), w2a,
                                      offs=offs)
            with tracing.span("moe.combine", device=True):
                out = _sum_slots(inv, y)
        if tracing.enabled():
            _count(offs[-1])
        ctx.save_for_backward(x, ws, h13, tok, offs, inv, held, w13, w2a)
        ctx.dtypes = (w.dtype, w1.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, ws, h13, tok, offs, inv, held, w13, w2a = ctx.saved_tensors
        need = ctx.needs_input_grad
        dtype, f32 = h13.dtype, ctx.dtypes[1]
        E, K, width = w2a.shape[0], w13.shape[1], w2a.shape[1] - AUG
        D = K - AUG
        h1, h3 = h13[:, :width], h13[:, width:]
        grads = [None] * 11
        with torch.autocast(x.device.type, enabled=False):
            with tracing.span("moe.combine.bwd", device=True):
                dy = dout.to(dtype).index_select(0, tok)
            with tracing.span("moe.experts.bwd", device=True):
                g = torch._grouped_mm(dy, w2a.transpose(1, 2),
                                      offs=offs)          # (R + 1, F + AUG)
                act = F.silu(h1)
                a = act * h3
                dws = ((g[:, :width] * a).sum(-1, dtype=torch.float32)
                       + g[:, width].float())
                dact = g[:, :width] * ws.to(dtype)[:, None]
                dh13 = torch.empty_like(h13)
                torch.ops.aten.silu_backward.grad_input(
                    dact * h3, h1, grad_input=dh13[:, :width])
                torch.mul(dact, act, out=dh13[:, width:])
                if need[7] or need[8]:
                    dw2 = torch._grouped_mm(_weighted(a, ws.to(dtype)).T,
                                            dy, offs=offs)
                    grads[7] = dw2[:, :width].to(f32)
                    grads[8] = dw2[:, width].to(f32)
                if any(need[3:7]):
                    xs = _augment(x.to(dtype)).index_select(0, tok)
                    dw13 = torch._grouped_mm(
                        xs.T, dh13, offs=offs)            # (E, D + AUG, 2 F)
                    grads[3:7] = (dw13[:, :D, :width].to(f32),
                                  dw13[:, D, :width].to(f32),
                                  dw13[:, :D, width:].to(f32),
                                  dw13[:, D, width:].to(f32))
                if need[0]:
                    dxs = torch._grouped_mm(
                        dh13, w13[:, :D].transpose(1, 2), offs=offs)
            with tracing.span("moe.dispatch.bwd", device=True):
                if need[0]:
                    grads[0] = _sum_slots(inv, dxs).to(x.dtype)
                if need[1]:
                    grads[1] = torch.where(held, dws[inv], 0.0).to(
                        ctx.dtypes[0])
        return tuple(grads)


def moe_experts(x, w, idx, w1, b1, w3, b3, w2, b2, first: int, dtype):
    """The held experts' part of the layer's output (N, D), in ``dtype``:
    for each row of x (N, D), the sum over its slots (w, idx from
    :func:`moe_route`) whose expert lies in ``[first, first + E)`` of
    w * expert(x).  Expert e's weights are w1[e - first] (D, F), w3 (the
    same), w2 (F, D) and its biases b1, b3 (F,), b2 (D,); the products run
    in ``dtype``.  ``moe_experts.launches`` counts calls."""
    moe_experts.launches += 1
    return _Experts.apply(x, w, idx, w1, b1, w3, b3, w2, b2, first, dtype)


moe_experts.launches = 0
_held = [None]      # the held assignments summed while tracing is on


def _count(n):
    t = _held[0]
    if t is None or t.device != n.device:
        t = _held[0] = torch.zeros((), dtype=torch.int64, device=n.device)
    t.add_(n)


def assignments():
    """The held assignments summed over the expert layers' forwards made
    while tracing was on: a copy of the device's count (0 before any), so
    reading it waits for nothing; ``tracing.snapshot`` makes it a number
    after the caller's synchronize."""
    t = _held[0]
    return 0 if t is None else t.clone()
