"""Plain reference of the Qwen3-MoE decoder's training loss, written from
the published equations (HF ``modeling_qwen3_moe``), for one chip's share
of expert parallelism:

- h = E[x];
- each layer: the Qwen3 attention block of ``reference/qwen3.py`` (q/k
  RMSNorm per head, GQA, rotary phases, no biases); then m = RMSNorm(h)
  and the expert layer: router probabilities p = softmax(m Wg^T) over all
  of the router's experts, each token's 8 (``num_experts_per_tok``)
  largest, their weights renormalised to sum to 1 (``norm_topk_prob``);
  h += sum over the token's selected experts e that this chip holds of
  weight_e * W_down,e (silu(W_gate,e m) * W_up,e m); no biases, no shared
  expert.  The experts this chip does not hold add nothing here (under
  expert parallelism their part lies on the other chips);
- RMSNorm(h) and the untied head: logits = h W_lm^T over the held slice of
  the vocabulary;
- the loss: mean cross-entropy over the targets that are not ``pad``.

Each held expert takes the tokens whose selection holds it, one expert at
a time.  Packed rows as in ``reference/qwen3.py``.  Weights come as the
HF state dict (``model.layers.{i}.mlp.gate.weight``,
``model.layers.{i}.mlp.experts.{e}.gate_proj.weight``, ...,
``lm_head.weight``); :func:`params` trains each layer's held experts'
matrices as one leaf per projection, stacked in expert order
(``model.layers.{i}.mlp.experts.gate_proj.weight`` (E, F, D), ...): the
granularity of the expert layer's own weights, at which a token that
picks another expert on the edge of its top k moves a part of the
leaf's gradient, not a whole leaf's.  Each layer is recomputed in the
backward.
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
from portbench.reference.qwen3 import rms_norm, rotary, turn

ATTENTION = ("input_layernorm.weight", "self_attn.q_proj.weight",
             "self_attn.k_proj.weight", "self_attn.v_proj.weight",
             "self_attn.q_norm.weight", "self_attn.k_norm.weight",
             "self_attn.o_proj.weight", "post_attention_layernorm.weight",
             "mlp.gate.weight")
EXPERT = ("gate_proj.weight", "up_proj.weight", "down_proj.weight")


def held(cfg: dict) -> range:
    """The router's indices of the experts this chip holds."""
    first, last = cfg["deployment"]["held_experts"]
    return range(first, last)


def params(weights: dict) -> dict:
    """float32 leaves to train from the HF state dict: each layer's held
    experts stacked into one leaf per projection, the rest as named."""
    out, experts = {}, {}
    for k, v in weights.items():
        head, sep, tail = k.partition(".mlp.experts.")
        if sep:
            e, name = tail.split(".", 1)
            experts.setdefault(f"{head}{sep}{name}", {})[int(e)] = v
        else:
            out[k] = v
    for k, by_e in experts.items():
        out[k] = torch.stack([by_e[e] for e in sorted(by_e)])
    return {k: v.detach().float().clone().requires_grad_(True)
            for k, v in out.items()}


def layer_leaves(i: int) -> list:
    """The names of layer i's leaves, in :func:`layer`'s order."""
    p = f"model.layers.{i}."
    return [p + n for n in ATTENTION] + [p + "mlp.experts." + n
                                         for n in EXPERT]


def route(m, gate, k: int, mode: str):
    """(weights (N, k), experts (N, k)) of the rows m (N, D): the k most
    probable experts and their probabilities renormalised over the k."""
    probs = torch.softmax(matmul(m, gate.mT, mode), -1)
    top, idx = probs.topk(k, -1)
    return top / top.sum(-1, keepdim=True), idx


def experts(cfg, mode, m, gate, w_gate, w_up, w_down):
    """The held experts' part of the expert layer's output for the rows
    m (N, D); the experts' matrices stacked in expert order."""
    weight, idx = route(m, gate, cfg["num_experts_per_tok"], mode)
    out = torch.zeros_like(m)
    for e, wg, wu, wd in zip(held(cfg), w_gate, w_up, w_down):
        hit = idx == e
        rows = hit.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:    # no token: nothing to add (nor to round)
            continue
        x = m[rows]
        y = matmul(F.silu(matmul(x, wg.mT, mode)) * matmul(x, wu.mT, mode),
                   wd.mT, mode)
        out = out.index_add(0, rows, y * (weight * hit).sum(-1)[rows, None])
    return out


def layer(cfg, mode, h, cos, sin, starts, ln1, wq, wk, wv, qn, kn, wo, ln2,
          gate, w_gate, w_up, w_down):
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
    m = rms_norm(h, ln2, eps).reshape(B * T, D)
    return h + experts(cfg, mode, m, gate, w_gate, w_up,
                       w_down).view(B, T, D)


def loss(p: dict, x, y, cfg: dict, bench: dict, mode: str):
    """Mean cross-entropy of the rows x -> y (B, T) under weights ``p``."""
    T = x.shape[1]
    starts = doc_starts(x, bench["separator"])
    positions = torch.arange(T, device=x.device) - starts
    cos, sin = rotary(positions, cfg["head_dim"], float(cfg["rope_theta"]))
    h = p["model.embed_tokens.weight"][x]
    step = functools.partial(layer, cfg, mode)
    for i in range(cfg["num_hidden_layers"]):
        h = recompute(step, h, cos, sin, starts,
                      *[p[n] for n in layer_leaves(i)])
    h = rms_norm(h, p["model.norm.weight"], cfg["rms_norm_eps"])
    w = torch.ones_like(y, dtype=torch.float32)
    if bench["pad"] is not None:
        w = (y != bench["pad"]).float()
    total = ce_sum(h.reshape(-1, h.shape[-1]), p["lm_head.weight"],
                   y.reshape(-1), w.reshape(-1), mode)
    return total / w.sum()
