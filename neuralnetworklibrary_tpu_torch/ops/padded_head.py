"""The LM head's product against a vocabulary padded to a multiple of
:data:`PAD_MULTIPLE` rows.

A 2-byte matrix whose leading dimension is not a multiple of 16 bytes
keeps cuBLAS off its aligned Hopper kernels.  GPT-2's 50,257-row tied head
makes two such matrices: the (N, V) logits, which the forward writes, and
their gradient, which both backward products read.  All three products
then run sm75 ``align1`` kernels, at ~13% of the bf16 peak on an H100.

:func:`padded_head` runs them against the head padded to ``Vp`` rows (the
pad rows zero): every operand's leading dimension is then ``Vp`` or the
model width.  The mathematics is ``F.linear(h, weight)``'s: the same
operands in the same dtype (autocast's, where it is on), float32
accumulation, and logits of shape (..., V) with the same values, a view
whose row stride is ``Vp``.  The pad columns of the logits are never read,
and those of the gradient are zero.  A gradient that arrives in the
logits' own layout, the (..., V) view of an (N, Vp) buffer (the
cross-entropy's, ``ops/cross_entropy.py``), is that padded buffer: the
backward zeroes its pad columns in place (:func:`padded_buffer`).  Any
other gradient it copies into a padded buffer and zeroes its pad
(:func:`pad_rows`).  :func:`pads_head` says where a product takes it.
"""

from __future__ import annotations

import torch

PAD_MULTIPLE = 64


def pads_head(device_type: str, vocab: int, decode: bool) -> bool:
    """Whether a head product takes :func:`padded_head`: on CUDA, over a
    full sequence, where a 2-byte row of ``vocab`` entries is not a
    multiple of 16 bytes.  A decode step's product is bound by reading the
    head once, which a padded copy would read again."""
    return device_type == "cuda" and vocab % 8 != 0 and not decode


def padded_vocab(vocab: int) -> int:
    """``vocab`` rounded up to a multiple of :data:`PAD_MULTIPLE`."""
    return -(-vocab // PAD_MULTIPLE) * PAD_MULTIPLE


def pad_rows(g, out):
    """Copy g (..., V) into the first V columns of ``out`` (N, Vp), N the
    rows of g, in ``out``'s dtype, and zero the other Vp - V.  W's pad rows are zero, but
    0 * NaN is not, so stale pad columns would reach dX."""
    V = g.shape[-1]
    out[:, :V].view(g.shape).copy_(g)
    out[:, V:].zero_()
    return out


def padded_buffer(g, rows: int, vp: int):
    """The (rows, vp) matrix of which ``g`` (..., V) is the first V
    columns, its rows vp elements apart in one storage, or None where ``g``
    is laid out otherwise."""
    if g.stride(-1) != 1 or g.numel() != rows * g.shape[-1]:
        return None
    want = vp
    for size, stride in zip(g.shape[-2::-1], g.stride()[-2::-1]):
        if size != 1 and stride != want:
            return None
        want *= size
    need = (g.storage_offset() + rows * vp) * g.element_size()
    if g.untyped_storage().nbytes() < need:
        return None
    return g.as_strided((rows, vp), (vp, 1))


class _PaddedHead(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, weight):
        V, D = weight.shape
        dev = h.device.type
        dtype = (torch.get_autocast_dtype(dev)
                 if torch.is_autocast_enabled(dev) else h.dtype)
        with torch.autocast(dev, enabled=False):
            w = weight.new_empty((padded_vocab(V), D), dtype=dtype)
            w[:V].copy_(weight)            # autocast's cast, into the pad
            w[V:].zero_()
            x = h.reshape(-1, D).to(dtype)
            out = x @ w.T
        ctx.save_for_backward(x, w)
        ctx.shape, ctx.dtypes = h.shape, (h.dtype, weight.dtype)
        return out.view(*h.shape[:-1], -1)[..., :V]

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        V, (N, Vp) = g.shape[-1], (x.shape[0], w.shape[0])
        gp = padded_buffer(g, N, Vp) if g.dtype == w.dtype else None
        if gp is None:
            gp = pad_rows(g, torch.empty((N, Vp), dtype=w.dtype,
                                         device=w.device))
        else:
            gp[:, V:].zero_()
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = (gp @ w).view(ctx.shape).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = (gp.T @ x)[:V].to(ctx.dtypes[1])
        return dh, dw


def padded_head(h, weight):
    """``F.linear(h, weight)`` through the padded product (see the module's
    doc): h (..., D), weight (V, D); logits (..., V).
    ``padded_head.launches`` counts calls."""
    padded_head.launches += 1
    return _PaddedHead.apply(h, weight)


padded_head.launches = 0
