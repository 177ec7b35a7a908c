"""Qwen3-MoE decoders (SDAR-30B-A3B keeps Qwen3-30B-A3B's network) as the
port trains one chip's share of them under expert parallelism: random
HF-layout weights of the held experts and vocabulary rows from the seed,
``utils.llama_convert.load_qwen3_moe`` into ``TransformerLM`` (flash
attention, packed rows restarting after the separator, every layer a
dropless top-k ``MoEMLP`` holding the configuration's
``deployment.held_experts`` of the router's ``deployment.router_experts``),
the packed cross-entropy, and the names that tie the port's leaves to the
reference's.

The port's converter gives the attention's ``nn.Linear`` layers and the
experts (``b1``, ``b3``, ``b2``) zero biases, which Qwen3-MoE lacks, so
the Learner trains exactly the leaves the published model has
(:func:`trainable`).
"""

from __future__ import annotations

import torch

# the harness trains this family's plain reference as ``family.reference``
from portbench.reference import qwen3_moe as reference

KERNELS = ("flash_attention",)   # the port's kernel sources it runs
ATTENTION_SHAPES = (("input_layernorm.weight", "D", None),
                    ("self_attn.q_proj.weight", "Q", "D"),
                    ("self_attn.k_proj.weight", "KV", "D"),
                    ("self_attn.v_proj.weight", "KV", "D"),
                    ("self_attn.q_norm.weight", "hd", None),
                    ("self_attn.k_norm.weight", "hd", None),
                    ("self_attn.o_proj.weight", "D", "Q"),
                    ("post_attention_layernorm.weight", "D", None),
                    ("mlp.gate.weight", "n", "D"))
EXPERT_SHAPES = (("gate_proj.weight", "F", "D"), ("up_proj.weight", "F", "D"),
                 ("down_proj.weight", "D", "F"))
# reference leaf (under model.layers.{i}.) -> port leaf (under block_{i}.)
# and, for the fused qkv projection, its rows: "q", "k" or "v"
PORT_ATTENTION = {"input_layernorm.weight": ("ln1.weight", None),
                  "self_attn.q_proj.weight": ("attn.qkv.weight", "q"),
                  "self_attn.k_proj.weight": ("attn.qkv.weight", "k"),
                  "self_attn.v_proj.weight": ("attn.qkv.weight", "v"),
                  "self_attn.q_norm.weight": ("attn.q_norm.weight", None),
                  "self_attn.k_norm.weight": ("attn.k_norm.weight", None),
                  "self_attn.o_proj.weight": ("attn.out.weight", None),
                  "post_attention_layernorm.weight": ("ln2.weight", None),
                  "mlp.gate.weight": ("moe.gate", None)}
# the reference's stacked experts (under model.layers.{i}.mlp.experts.)
# -> the port's stacked leaf
PORT_EXPERT = {"gate_proj.weight": "moe.w1", "up_proj.weight": "moe.w3",
               "down_proj.weight": "moe.w2"}
BIASES = (".bias", ".b1", ".b2", ".b3")


def _sizes(cfg):
    hd = cfg["head_dim"]
    return {"D": cfg["hidden_size"], "hd": hd,
            "Q": cfg["num_attention_heads"] * hd,
            "KV": cfg["num_key_value_heads"] * hd,
            "F": cfg["moe_intermediate_size"],
            "n": cfg["deployment"]["router_experts"]}


def _check(cfg):
    first, last = cfg["deployment"]["held_experts"]
    if last - first != cfg["num_experts"]:
        raise ValueError("num_experts counts the held experts")
    if cfg["tie_word_embeddings"] or cfg["attention_bias"]:
        raise ValueError("this family file covers untied, bias-free "
                         "Qwen3-MoE")
    if (cfg["hidden_act"] != "silu" or cfg.get("rope_scaling")
            or not cfg["norm_topk_prob"] or cfg["decoder_sparse_step"] != 1
            or cfg["mlp_only_layers"]):
        raise ValueError("this family file covers SwiGLU experts in every "
                         "layer, renormalised top-k, without rope scaling")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """An HF Qwen3MoeForCausalLM state dict of the held experts and
    vocabulary rows on ``device``: every matrix normal(0,
    initializer_range) from one draw of a device generator seeded with
    ``seed``, norm scales 1."""
    _check(cfg)
    s = _sizes(cfg)
    V = cfg["vocab_size"]
    shapes = {"model.embed_tokens.weight": (V, s["D"]),
              "model.norm.weight": (s["D"],),
              "lm_head.weight": (V, s["D"])}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, a, b in ATTENTION_SHAPES:
            shapes[p + name] = (s[a],) if b is None else (s[a], s[b])
        for e in reference.held(cfg):
            for name, a, b in EXPERT_SHAPES:
                shapes[f"{p}mlp.experts.{e}.{name}"] = (s[a], s[b])
    mats = {k: v for k, v in shapes.items() if len(v) == 2}
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.empty(sum(a * b for a, b in mats.values()), device=device)
    flat.normal_(0.0, cfg["initializer_range"], generator=g)
    out, at = {}, 0
    for k, shape in shapes.items():
        if len(shape) == 1:
            out[k] = torch.ones(shape, device=device)
            continue
        n = shape[0] * shape[1]
        out[k] = flat[at:at + n].view(shape)
        at += n
    return out


def build(cfg: dict, weights: dict, device):
    """The port's model of these weights, by the converter a user calls."""
    from neuralnetworklibrary_tpu_torch.utils.llama_convert import (
        load_qwen3_moe,
    )

    model, _ = load_qwen3_moe(
        weights, cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], d_model=cfg["hidden_size"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"],
        n_experts=cfg["deployment"]["router_experts"],
        moe_top_k=cfg["num_experts_per_tok"],
        d_ff=cfg["moe_intermediate_size"],
        n_kv_heads=cfg["num_key_value_heads"],
        moe_experts=tuple(cfg["deployment"]["held_experts"]),
        max_len=cfg["max_position_embeddings"],
        rope_base=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        flash_attention=True, reset_at=cfg["bench"]["separator"],
        device=device)
    return model


def loss_func(cfg: dict):
    from neuralnetworklibrary_tpu_torch.nn.transformer import (
        PackedSeqCrossEntropyLoss,
    )

    return PackedSeqCrossEntropyLoss(cfg["bench"]["pad"])


def trainable(cfg: dict, name: str) -> bool:
    """Whether the port's leaf ``name`` is one the published model has."""
    return not name.endswith(BIASES)


def leaf_map(cfg: dict) -> dict:
    """{reference leaf: (port leaf, rows)}: rows (start, end) of the port
    leaf's first axis that hold the reference leaf, or None for all."""
    s = _sizes(cfg)
    Q, KV = s["Q"], s["KV"]
    rows = {None: None, "q": (0, Q), "k": (Q, Q + KV),
            "v": (Q + KV, Q + 2 * KV)}
    out = {"model.embed_tokens.weight": ("word_embed", None),
           "lm_head.weight": ("lm_head", None),
           "model.norm.weight": ("ln_f.weight", None)}
    for i in range(cfg["num_hidden_layers"]):
        p, q = f"model.layers.{i}.", f"block_{i}."
        for ref, (port, part) in PORT_ATTENTION.items():
            out[p + ref] = (q + port, rows[part])
        for ref, port in PORT_EXPERT.items():
            out[f"{p}mlp.experts.{ref}"] = (q + port, None)
    return out


def port_layout(name: str, t):
    """A reference leaf's tensor in the port's layout: the router's and the
    experts' HF (out, in) matrices are the port's (in, out); the rest is
    the port's."""
    if name.endswith("mlp.gate.weight"):
        return t.T
    if ".mlp.experts." in name:
        return t.transpose(1, 2)
    return t


def dims(cfg: dict) -> dict:
    """Sizes the yardstick's arithmetic needs: layers, query heads, key
    and value heads, head width, the matrix parameters a token multiplies
    (attention, the router, the held share of its experts, k held / n of
    them on average, and the head), and the expert layer's sizes."""
    s = _sizes(cfg)
    held = cfg["num_experts_per_tok"] * cfg["num_experts"] / s["n"]
    per_layer = ((2 * s["Q"] + 2 * s["KV"] + s["n"]) * s["D"]
                 + held * 3 * s["F"] * s["D"])
    return {"L": cfg["num_hidden_layers"], "H": cfg["num_attention_heads"],
            "Hkv": cfg["num_key_value_heads"], "hd": s["hd"],
            "separator": cfg["bench"]["separator"],
            "n_matmul": int(cfg["num_hidden_layers"] * per_layer
                            + cfg["vocab_size"] * s["D"]),
            "D": s["D"], "moe_ff": s["F"], "moe_held": cfg["num_experts"]}
