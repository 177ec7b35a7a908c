"""Plain reference of the Mellum 2 decoder's training loss (HF ``config.json``
of ``JetBrains/Mellum2-12B-A2.5B-Instruct``, ``model_type`` 'mellum'),
written from its published description, for one pipeline stage:

- h = E[x];
- each layer i: a = RMSNorm(h); q, k, v = a Wq^T, a Wk^T, a Wv^T in heads
  of ``head_dim`` (no biases), q and k RMS-normalised per head, then
  turned by the rotary phases of the layer's type,
  ``rope_parameters[layer_types[i]]``: split-half pairs i and i + hd/2,
  angle position x inv_freq[i], inv_freq[i] = theta^(-2i/hd); on a 'yarn'
  type (the full layers) inv_freq is YaRN's blend of theta^(-2i/hd) / factor
  and theta^(-2i/hd), by a ramp over the dims between the correction dims
  of ``beta_fast`` and ``beta_slow`` at ``original_max_position_embeddings``
  (floored and ceiled), and cos and sin are scaled by ``attention_factor``;
  softmax attention with scale 1/sqrt(hd), each query head reading kv head
  h // (H / Hkv): query t sees key s when s <= t, s lies in t's document
  and, on a 'sliding_attention' layer, t - s < ``sliding_window`` (the
  last ``sliding_window`` keys, t's own included; HF's
  ``sliding_window_overlay``); h += o Wo^T;
- the expert layer of every layer (``mlp_layer_types`` all 'sparse'):
  ``reference/qwen3_moe.py``'s router softmax over the ``num_experts``
  experts, each token's top ``num_experts_per_tok`` renormalised
  (``norm_topk_prob``), SwiGLU experts of ``moe_intermediate_size``, no
  shared expert, no biases;
- RMSNorm(h) and the untied head over the held vocabulary rows; the loss:
  mean cross-entropy over the targets that are not ``pad``.

Departures from the published model, each the configuration's
``assumed``: q/k norms (the config has no key for them; Qwen3-MoE's
layout, which its keys match); no router auxiliary loss; no multi-token
prediction head (the model card names one, the config gives it no key).

Packed rows as ``reference/qwen3.py``: a document starts right after each
separator and its positions count from 0 there.  Each layer is recomputed
in the backward, and so is each block of ``ROWS`` queries of its
attention (``common.recompute``: ``torch.utils.checkpoint``'s work without
its start-up), so that a full layer at T 32,768 keeps one block's scores
at a time.  Weights are Qwen3-MoE's HF names; :func:`params`
stacks each layer's experts (``reference/qwen3_moe.py``).
"""

from __future__ import annotations

import functools
import math

import torch
from portbench.reference.common import (
    ce_sum,
    doc_starts,
    matmul,
    recompute,
)
from portbench.reference.qwen3 import rms_norm, turn
# ``params`` is the harness's (``family.reference.params``)
from portbench.reference.qwen3_moe import (  # noqa: F401
    experts,
    layer_leaves,
    params,
)

ROWS = 512      # queries an attention block


def rope(positions, hd: int, rp: dict):
    """cos, sin (B, T, 1, hd/2) of one layer type's rotary phases
    (``rope_parameters[type]``), the angles in float64."""
    theta = float(rp["rope_theta"])
    i = torch.arange(0, hd // 2, dtype=torch.float64,
                     device=positions.device)
    inv = theta ** (-2.0 * i / hd)
    scale = 1.0
    kind = rp.get("rope_type", "default")
    if kind == "yarn":
        factor = float(rp["factor"])
        orig = float(rp["original_max_position_embeddings"])

        def dim(rotations):   # the dim that turns ``rotations`` times
            return (hd * math.log(orig / (rotations * 2 * math.pi))
                    / (2 * math.log(theta)))

        low = max(math.floor(dim(float(rp["beta_fast"]))), 0)
        high = min(math.ceil(dim(float(rp["beta_slow"]))), hd - 1)
        if low == high:
            high += 0.001
        ramp = ((i - low) / (high - low)).clamp(0.0, 1.0)
        inv = inv / factor * ramp + inv * (1.0 - ramp)
        scale = float(rp["attention_factor"])
    elif kind != "default":
        raise ValueError(f"rope_type {kind!r} is not in this reference")
    ang = positions.double()[..., None] * inv
    return ((torch.cos(ang) * scale).float()[:, :, None],
            (torch.sin(ang) * scale).float()[:, :, None])


def _block(mode, hd, window, a, q, k, v, starts):
    """Softmax attention of the queries a .. a + n - 1 (q (B, H, n, hd))
    over the keys lo .. lo + m - 1 (k, v (B, H, m, hd)), lo = a - m + n."""
    n, m = q.shape[2], k.shape[2]
    s = matmul(q, k.mT, mode) / math.sqrt(hd)
    t = torch.arange(a, a + n, device=q.device)[:, None]
    key = torch.arange(a + n - m, a + n, device=q.device)[None]
    ok = key <= t
    if window > 0:
        ok = ok & (t - key < window)
    ok = ok[None] & (key[None] >= starts[:, :, None])
    s = s.masked_fill(~ok[:, None], float("-inf"))
    return matmul(torch.softmax(s, -1), v, mode)


def attention(q, k, v, starts, window: int, mode: str, rows: int = ROWS):
    """Causal softmax attention of q (B, T, H, hd) over k, v (B, T, Hkv, hd)
    within documents, over the last ``window`` keys of each query where
    ``window`` > 0; ``rows`` queries at a time, each block over the keys
    from its first query's window start to its last query, recomputed in
    the backward.  Returns (B, T, H * hd)."""
    B, T, H, hd = q.shape
    rep = H // k.shape[2]
    q = q.transpose(1, 2)
    k = k.repeat_interleave(rep, dim=2).transpose(1, 2)
    v = v.repeat_interleave(rep, dim=2).transpose(1, 2)
    out = []
    for a in range(0, T, rows):
        b = min(a + rows, T)
        lo = max(0, a - window + 1) if window > 0 else 0
        out.append(recompute(functools.partial(_block, mode, hd, window, a),
                             q[:, :, a:b], k[:, :, lo:b], v[:, :, lo:b],
                             starts[:, a:b]))
    return torch.cat(out, 2).transpose(1, 2).reshape(B, T, H * hd)


def layer(cfg, mode, window, h, cos, sin, starts, ln1, wq, wk, wv, qn, kn,
          wo, ln2, gate, w_gate, w_up, w_down):
    B, T, D = h.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    a = rms_norm(h, ln1, eps)
    q = rms_norm(matmul(a, wq.mT, mode).view(B, T, H, hd), qn, eps)
    k = rms_norm(matmul(a, wk.mT, mode).view(B, T, Hkv, hd), kn, eps)
    v = matmul(a, wv.mT, mode).view(B, T, Hkv, hd)
    o = attention(turn(q, cos, sin), turn(k, cos, sin), v, starts, window,
                  mode)
    h = h + matmul(o, wo.mT, mode)
    m = rms_norm(h, ln2, eps).reshape(B * T, D)
    return h + experts(cfg, mode, m, gate, w_gate, w_up,
                       w_down).view(B, T, D)


def window(cfg: dict, i: int) -> int:
    """Layer i's window: ``sliding_window`` on a 'sliding_attention'
    layer, 0 (every key of the document) on a 'full_attention' one."""
    kind = cfg["layer_types"][i]
    if kind not in ("sliding_attention", "full_attention"):
        raise ValueError(f"layer type {kind!r} is not in this reference")
    return int(cfg["sliding_window"]) if kind == "sliding_attention" else 0


def loss(p: dict, x, y, cfg: dict, bench: dict, mode: str):
    """Mean cross-entropy of the rows x -> y (B, T) under weights ``p``."""
    if any(t != "sparse" for t in cfg["mlp_layer_types"]):
        raise ValueError("this reference has an expert layer in every layer")
    T = x.shape[1]
    starts = doc_starts(x, bench["separator"])
    positions = torch.arange(T, device=x.device) - starts
    phases = {kind: rope(positions, cfg["head_dim"], rp)
              for kind, rp in cfg["rope_parameters"].items()}
    h = p["model.embed_tokens.weight"][x]
    for i in range(cfg["num_hidden_layers"]):
        step = functools.partial(layer, cfg, mode, window(cfg, i))
        h = recompute(step, h, *phases[cfg["layer_types"][i]], starts,
                      *[p[n] for n in layer_leaves(i)])
    h = rms_norm(h, p["model.norm.weight"], cfg["rms_norm_eps"])
    w = torch.ones_like(y, dtype=torch.float32)
    if bench["pad"] is not None:
        w = (y != bench["pad"]).float()
    total = ce_sum(h.reshape(-1, h.shape[-1]), p["lm_head.weight"],
                   y.reshape(-1), w.reshape(-1), mode)
    return total / w.sum()
