"""Vocab-chunked softmax cross-entropy for LM decoders.

Counterpart of ``neuralnetworklibrary_tpu/ops/chunked_ce.py``.  The masked
mean token CE of the decoder ``h @ emb.T`` without the (B, T, V) logits:
the forward streams the vocabulary in chunks of ``chunk`` rows of ``emb``
and folds each chunk into an online logsumexp in float32; the backward
recomputes each chunk's softmax from the saved logsumexp.  Memory drops
from O(B*T*V) to O(B*T*chunk); the backward does two more chunk products.
Gradients reach both h and the decoder matrix (the tied embedding or an
untied head).  The chunk products are ``torch.matmul``: the JAX package
leaves them to XLA, outside any Pallas kernel.

:func:`dense_softmax_ce` is the plain yardstick (it builds the logits).
"""

from __future__ import annotations

import torch


class _ChunkedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, emb, targets, mask, chunk):
        hf, tf = h.reshape(-1, h.shape[-1]), targets.reshape(-1).long()
        mf = (torch.ones(hf.shape[0], device=h.device) if mask is None
              else mask.reshape(-1).float())
        m = torch.full((hf.shape[0],), float("-inf"), device=h.device)
        s = torch.zeros(hf.shape[0], device=h.device)
        for c0 in range(0, emb.shape[0], chunk):
            logits = (hf @ emb[c0:c0 + chunk].T).float()
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
        lse = m + torch.log(s)
        tgt_logit = (hf.float() * emb[tf].float()).sum(-1)
        denom = mf.sum().clamp_min(1.0)
        ctx.save_for_backward(h, emb, tf, mf, lse)
        ctx.chunk = chunk
        return ((lse - tgt_logit) * mf).sum() / denom

    @staticmethod
    def backward(ctx, g):
        h, emb, tf, mf, lse = ctx.saved_tensors
        hf = h.reshape(-1, h.shape[-1]).float()
        w = g * mf / mf.sum().clamp_min(1.0)          # (N,) per token
        dh = torch.zeros_like(hf)
        demb = torch.empty(emb.shape, dtype=torch.float32, device=emb.device)
        # dh = sum_v p_v emb_v - emb_target; demb_v = sum_n p_nv h_n - scatter
        for c0 in range(0, emb.shape[0], ctx.chunk):
            e = emb[c0:c0 + ctx.chunk].float()
            pw = torch.exp(hf @ e.T - lse[:, None]) * w[:, None]
            dh += pw @ e
            demb[c0:c0 + ctx.chunk] = pw.T @ hf
        dh -= w[:, None] * emb[tf].float()
        demb.index_add_(0, tf, -w[:, None] * hf)
        return (dh.reshape(h.shape).to(h.dtype), demb.to(emb.dtype), None,
                None, None)


def chunked_softmax_ce(h, emb, targets, mask=None, chunk: int = 8192):
    """Masked mean token CE of ``h @ emb.T`` streamed over the vocabulary.

    h (B, T, D), emb (V, D), targets (B, T) integer, mask (B, T) (1 counts
    the token) or None for every token.  Reductions in float32; the
    gradients come back in h's and emb's dtypes.  Equals
    :func:`dense_softmax_ce` up to the order of the sums."""
    return _ChunkedCE.apply(h, emb, targets, mask, int(chunk))


def dense_softmax_ce(h, emb, targets, mask=None):
    """The plain version: CE(h @ emb.T) with the same masked-mean
    reduction, the (B, T, V) logits built."""
    logits = torch.einsum("btd,vd->btv", h, emb).float()
    tgt = logits.gather(-1, targets.long()[..., None])[..., 0]
    mf = (torch.ones_like(tgt) if mask is None else mask.float())
    nll = torch.logsumexp(logits, -1) - tgt
    return (nll * mf).sum() / mf.sum().clamp_min(1.0)
