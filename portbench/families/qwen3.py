"""Qwen3 dense decoders as the port trains them: random HF-layout weights
from the seed, ``utils.llama_convert.load_qwen3`` into ``TransformerLM``
(flash attention, packed rows restarting after the separator), the
packed cross-entropy that leaves out pad targets, and the names that tie
the port's leaves to the reference's.

Qwen3 has no attention or MLP biases (``attention_bias`` false); the
port's converter gives its ``nn.Linear`` layers zero biases, so the
Learner trains exactly the leaves the published model has
(:func:`trainable`) and the zero biases stay out of the step.
"""

from __future__ import annotations

import torch

# the harness trains this family's plain reference as ``family.reference``
from portbench.reference import qwen3 as reference

LAYER_SHAPES = (("input_layernorm.weight", "D", None),
                ("self_attn.q_proj.weight", "Q", "D"),
                ("self_attn.k_proj.weight", "KV", "D"),
                ("self_attn.v_proj.weight", "KV", "D"),
                ("self_attn.q_norm.weight", "hd", None),
                ("self_attn.k_norm.weight", "hd", None),
                ("self_attn.o_proj.weight", "D", "Q"),
                ("post_attention_layernorm.weight", "D", None),
                ("mlp.gate_proj.weight", "F", "D"),
                ("mlp.up_proj.weight", "F", "D"),
                ("mlp.down_proj.weight", "D", "F"))
KERNELS = ("flash_attention",)   # the port's kernel sources it runs
# reference leaf (under model.layers.{i}.) -> port leaf (under block_{i}.)
# and, for the fused qkv projection, its rows: "q", "k" or "v"
PORT_LAYER = {"input_layernorm.weight": ("ln1.weight", None),
              "self_attn.q_proj.weight": ("attn.qkv.weight", "q"),
              "self_attn.k_proj.weight": ("attn.qkv.weight", "k"),
              "self_attn.v_proj.weight": ("attn.qkv.weight", "v"),
              "self_attn.q_norm.weight": ("attn.q_norm.weight", None),
              "self_attn.k_norm.weight": ("attn.k_norm.weight", None),
              "self_attn.o_proj.weight": ("attn.out.weight", None),
              "post_attention_layernorm.weight": ("ln2.weight", None),
              "mlp.gate_proj.weight": ("mlp.fc_in.weight", None),
              "mlp.up_proj.weight": ("mlp.fc_gate.weight", None),
              "mlp.down_proj.weight": ("mlp.fc_out.weight", None)}


def _sizes(cfg):
    hd = cfg["head_dim"]
    return {"D": cfg["hidden_size"], "hd": hd,
            "Q": cfg["num_attention_heads"] * hd,
            "KV": cfg["num_key_value_heads"] * hd,
            "F": cfg["intermediate_size"]}


def _check(cfg):
    if not cfg["tie_word_embeddings"] or cfg["attention_bias"]:
        raise ValueError("this family file covers tied, bias-free Qwen3")
    if cfg["hidden_act"] != "silu" or cfg.get("rope_scaling"):
        raise ValueError("this family file covers SwiGLU without rope "
                         "scaling")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """An HF Qwen3ForCausalLM state dict (tied: no lm_head) on ``device``:
    every matrix normal(0, initializer_range) from one draw of a device
    generator seeded with ``seed``, norm scales 1."""
    _check(cfg)
    s = _sizes(cfg)
    shapes = {"model.embed_tokens.weight": (cfg["vocab_size"], s["D"]),
              "model.norm.weight": (s["D"],)}
    for i in range(cfg["num_hidden_layers"]):
        for name, a, b in LAYER_SHAPES:
            shapes[f"model.layers.{i}.{name}"] = (
                (s[a],) if b is None else (s[a], s[b]))
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
    from neuralnetworklibrary_tpu_torch.utils.llama_convert import load_qwen3

    model, _ = load_qwen3(
        weights, cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], d_model=cfg["hidden_size"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"],
        max_len=cfg["max_position_embeddings"],
        rope_base=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"],
        drop=cfg["attention_dropout"], flash_attention=True,
        reset_at=cfg["bench"]["separator"], device=device)
    return model


def loss_func(cfg: dict):
    from neuralnetworklibrary_tpu_torch.nn.transformer import (
        PackedSeqCrossEntropyLoss,
    )

    return PackedSeqCrossEntropyLoss(cfg["bench"]["pad"])


def trainable(cfg: dict, name: str) -> bool:
    """Whether the port's leaf ``name`` is one the published model has."""
    return not name.endswith(".bias")


def leaf_map(cfg: dict) -> dict:
    """{reference leaf: (port leaf, rows)}: rows (start, end) of the port
    leaf's first axis that hold the reference leaf, or None for all."""
    s = _sizes(cfg)
    Q, KV = s["Q"], s["KV"]
    rows = {None: None, "q": (0, Q), "k": (Q, Q + KV),
            "v": (Q + KV, Q + 2 * KV)}
    out = {"model.embed_tokens.weight": ("word_embed", None),
           "model.norm.weight": ("ln_f.weight", None)}
    for i in range(cfg["num_hidden_layers"]):
        for ref, (port, part) in PORT_LAYER.items():
            out[f"model.layers.{i}.{ref}"] = (f"block_{i}.{port}",
                                              rows[part])
    return out


def port_layout(name: str, t):
    """A reference leaf's tensor in the port's layout: HF's (out, in) is
    the port's."""
    return t


def dims(cfg: dict) -> dict:
    """Sizes the yardstick's arithmetic needs: layers, query heads, key
    and value heads, head width, and the matrix parameters a token
    multiplies (every layer's and the tied head's)."""
    s = _sizes(cfg)
    per_layer = (2 * s["Q"] + 2 * s["KV"] + 3 * s["F"]) * s["D"]
    return {"L": cfg["num_hidden_layers"], "H": cfg["num_attention_heads"],
            "Hkv": cfg["num_key_value_heads"], "hd": s["hd"],
            "separator": cfg["bench"]["separator"],
            "n_matmul": cfg["num_hidden_layers"] * per_layer
            + cfg["vocab_size"] * s["D"]}
