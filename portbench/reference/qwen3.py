"""Plain reference of the Qwen3 dense decoder's training loss, written from
the published equations (HF ``modeling_qwen3``, Qwen3 technical report):

- h = E[x];
- each layer: a = RMSNorm(h); q, k, v = a Wq^T, a Wk^T, a Wv^T in heads of
  ``head_dim`` (no biases), q and k RMS-normalised per head, then turned
  by rotary phases (split-half pairs i and i + hd/2, angle position x
  theta^(-2i/hd)); causal attention with scale 1/sqrt(hd), each query
  head reading kv head h // (H / Hkv); h += o Wo^T; m = RMSNorm(h);
  h += W_down (silu(W_gate m) * W_up m);
- RMSNorm(h) and the tied head: logits = h E^T;
- the loss: mean cross-entropy over the targets that are not ``pad``.

Packed rows: a document starts right after each separator token, its
positions count from 0 there, and its queries see only its own keys.

Weights are the HF state-dict names (``model.embed_tokens.weight``,
``model.layers.{i}.self_attn.q_proj.weight``, ...).  Each layer is
recomputed in the backward rather than kept, attention and the head run
in blocks, so the step fits on one card at the benchmark's sizes.
"""

from __future__ import annotations

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

LAYER = ("input_layernorm.weight", "self_attn.q_proj.weight",
         "self_attn.k_proj.weight", "self_attn.v_proj.weight",
         "self_attn.q_norm.weight", "self_attn.k_norm.weight",
         "self_attn.o_proj.weight", "post_attention_layernorm.weight",
         "mlp.gate_proj.weight", "mlp.up_proj.weight",
         "mlp.down_proj.weight")


def params(weights: dict) -> dict:
    """float32 leaves to train, copied from the HF state dict."""
    return {k: v.detach().float().clone().requires_grad_(True)
            for k, v in weights.items()}


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotary(positions, hd: int, theta: float):
    """cos, sin (B, T, 1, hd/2) of the rotary angles, computed in float64."""
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=positions.device) / hd)
    ang = positions.double()[..., None] * inv
    return (torch.cos(ang).float()[:, :, None],
            torch.sin(ang).float()[:, :, None])


def turn(x, cos, sin):
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def layer(cfg, mode, h, cos, sin, starts, ln1, wq, wk, wv, qn, kn, wo, ln2,
          wg, wu, wd):
    B, T, D = h.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    a = rms_norm(h, ln1, eps)
    q = rms_norm(matmul(a, wq.mT, mode).view(B, T, H, hd), qn, eps)
    k = rms_norm(matmul(a, wk.mT, mode).view(B, T, Hkv, hd), kn, eps)
    v = matmul(a, wv.mT, mode).view(B, T, Hkv, hd)
    o = causal_attention(turn(q, cos, sin), turn(k, cos, sin), v, starts,
                         mode)
    h = h + matmul(o, wo.mT, mode)
    m = rms_norm(h, ln2, eps)
    g = F.silu(matmul(m, wg.mT, mode)) * matmul(m, wu.mT, mode)
    return h + matmul(g, wd.mT, mode)


def loss(p: dict, x, y, cfg: dict, bench: dict, mode: str):
    """Mean cross-entropy of the rows x -> y (B, T) under weights ``p``."""
    T = x.shape[1]
    starts = doc_starts(x, bench["separator"])
    positions = torch.arange(T, device=x.device) - starts
    cos, sin = rotary(positions, cfg["head_dim"], float(cfg["rope_theta"]))
    emb = p["model.embed_tokens.weight"]
    h = emb[x]
    step = functools.partial(layer, cfg, mode)
    for i in range(cfg["num_hidden_layers"]):
        ws = [p[f"model.layers.{i}.{n}"] for n in LAYER]
        h = recompute(step, h, cos, sin, starts, *ws)
    h = rms_norm(h, p["model.norm.weight"], cfg["rms_norm_eps"])
    w = torch.ones_like(y, dtype=torch.float32)
    if bench["pad"] is not None:
        w = (y != bench["pad"]).float()
    total = ce_sum(h.reshape(-1, h.shape[-1]), emb, y.reshape(-1),
                   w.reshape(-1), mode)
    return total / w.sum()
