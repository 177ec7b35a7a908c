"""Plain reference of GPT-2's training loss, written from the published
equations (Radford et al. 2019; HF ``modeling_gpt2``):

- h = wte[x] + wpe[position], positions 0..T-1 along each row (a
  document separator inside a row is attended across, as GPT-2 trains);
- each layer: a = LayerNorm(h); q = a W_q + b_q, k = a W_k + b_k and
  v = a W_v + b_v in heads of d/H; causal attention with scale
  1/sqrt(d/H); h += o W_o + b_o; m = LayerNorm(h);
  h += gelu_tanh(m W_fc + b_fc) W_proj + b_proj,
  gelu_tanh(z) = z/2 (1 + tanh(sqrt(2/pi) (z + 0.044715 z^3)));
- LayerNorm(h) and the tied head: logits = h wte^T;
- the loss: mean cross-entropy over every target.

Weights come as the flax-layout tree flattened with "/" (``word_embed``,
``pos_embed``, ``block_{i}/attn/qkv/kernel`` of shape (in, out), ...,
``ln_f/scale``); :func:`params` holds q, k and v apart
(``block_{i}/attn/q/kernel`` ...), as the equations name them.  Each
layer is recomputed in the backward rather than kept, attention and the
head run in blocks.
"""

from __future__ import annotations

import math

import functools

import torch
import torch.nn.functional as F
from portbench.reference.common import (
    causal_attention,
    ce_sum,
    doc_starts,
    matmul,
    recompute,
)

LAYER = ("ln1/scale", "ln1/bias", "attn/q/kernel", "attn/q/bias",
         "attn/k/kernel", "attn/k/bias", "attn/v/kernel", "attn/v/bias",
         "attn/out/kernel", "attn/out/bias", "ln2/scale", "ln2/bias",
         "mlp/fc_in/kernel", "mlp/fc_in/bias", "mlp/fc_out/kernel",
         "mlp/fc_out/bias")


def gelu_tanh(z):
    return 0.5 * z * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (z + 0.044715 * z ** 3)))


def params(tree: dict) -> dict:
    """float32 leaves to train, copied from the flax-layout tree, with the
    fused qkv kernel (in, 3 d) and bias (3 d) split into q, k and v."""
    out = {}
    for k, v in tree.items():
        v = v.detach().float()
        if "/qkv/" not in k:
            out[k] = v.clone().requires_grad_(True)
            continue
        for part, t in zip("qkv", v.chunk(3, dim=-1)):
            out[k.replace("/qkv/", f"/{part}/")] = (
                t.contiguous().requires_grad_(True))
    return out


def layer(cfg, mode, h, starts, g1, b1, wq, bq, wk, bk, wv, bv, wo, bo, g2,
          b2, wfc, bfc, wpr, bpr):
    B, T, D = h.shape
    H, eps = cfg["n_head"], cfg["layer_norm_epsilon"]
    a = F.layer_norm(h, (D,), g1, b1, eps)
    q, k, v = ((matmul(a, w, mode) + b).view(B, T, H, D // H)
               for w, b in ((wq, bq), (wk, bk), (wv, bv)))
    h = h + matmul(causal_attention(q, k, v, starts, mode), wo, mode) + bo
    m = F.layer_norm(h, (D,), g2, b2, eps)
    return h + matmul(gelu_tanh(matmul(m, wfc, mode) + bfc), wpr, mode) + bpr


def loss(p: dict, x, y, cfg: dict, bench: dict, mode: str):
    """Mean cross-entropy of the rows x -> y (B, T) under weights ``p``."""
    T, D = x.shape[1], cfg["n_embd"]
    starts = doc_starts(x, None)
    h = p["word_embed"][x] + p["pos_embed"][:T]
    step = functools.partial(layer, cfg, mode)
    for i in range(cfg["n_layer"]):
        ws = [p[f"block_{i}/{n}"] for n in LAYER]
        h = recompute(step, h, starts, *ws)
    h = F.layer_norm(h, (D,), p["ln_f/scale"], p["ln_f/bias"],
                     cfg["layer_norm_epsilon"])
    w = torch.ones_like(y, dtype=torch.float32)
    total = ce_sum(h.reshape(-1, D), p["word_embed"], y.reshape(-1),
                   w.reshape(-1), mode)
    return total / w.sum()
