"""Convert HuggingFace Llama and Qwen3 weights into the port's
:class:`nn.transformer.TransformerLM`.

Counterpart of ``neuralnetworklibrary_tpu/utils/llama_convert.py`` for the
Llama and Qwen3 families.  The Llama block is the modern configuration of
``TransformerLM``: pre-RMSNorm blocks, rotary phases in the split-half
convention, grouped-query attention, a SwiGLU MLP and an untied
``lm_head``; Qwen3 adds a per-head RMSNorm on q and k (``qk_norm``) and a
``head_dim`` apart from hidden_size.  :func:`convert_llama_state_dict`
gives the JAX package's flax tree (the same numpy arrays, leaf for leaf):
HF ``nn.Linear`` weights (out, in) transposed to kernels (in, out), q, k
and v concatenated along the output axis into the fused ``qkv`` ([q | k |
v], widths H*hd | Hkv*hd | Hkv*hd), zero biases where the checkpoint has
none (exact), and the MLP's ``fc_in`` the silu side (HF ``gate_proj``),
``fc_gate`` the other (``up_proj``).  :func:`load_llama` and
:func:`load_qwen3` build the model and fill it with
``utils.jax_params.load_jax_params``.  The state dicts are mappings of
numpy arrays or tensors; nothing here imports ``transformers``.

Qwen3-MoE (:func:`convert_qwen3_moe_state_dict`, :func:`load_qwen3_moe`)
keeps the Qwen3 attention and puts a ``moe`` layer in the MLP's place:
the router ``mlp.gate.weight`` (n_experts, D) as ``gate`` (D, n_experts),
and of the held experts ``e`` (all, or ``experts`` = (first, last))
``mlp.experts.{e}.gate_proj`` / ``up_proj`` / ``down_proj`` stacked and
transposed into ``w1``, ``w3`` (E, D, F) and ``w2`` (E, F, D), with zero
biases ``b1``, ``b3``, ``b2`` (the JAX ``MoEMLP`` layout).

Mellum (``model_type`` 'mellum', :func:`load_config` and
:func:`load_llama_dir`) is Qwen3-MoE's layout with each layer's attention
named by ``layer_types`` (sliding-window or full) and rotary phases given
by layer type (``rope_parameters``): the model's ``window_pattern`` and
``rope_pattern``.

Not ported yet (ROADMAP Queue 1): the Mixtral, Gemma, Gemma2, GPT-OSS,
Phi-2 and Phi-3 converters.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from neuralnetworklibrary_tpu_torch.nn.transformer import (
    TransformerLM,
    rope_scaling_tuple,
)
from neuralnetworklibrary_tpu_torch.utils import tracing
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params
from neuralnetworklibrary_tpu_torch.utils.safetensors_io import (
    load_safetensors_auto,
)


def _t(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy()
    return np.asarray(x, np.float32)


def _dense_mlp(sd, p):
    gate = _t(sd[p + "mlp.gate_proj.weight"]).T       # (D, F)
    up = _t(sd[p + "mlp.up_proj.weight"]).T
    down = _t(sd[p + "mlp.down_proj.weight"]).T       # (F, D)
    return "mlp", {name: {"kernel": w,
                          "bias": np.zeros(w.shape[1], np.float32)}
                   for name, w in (("fc_in", gate), ("fc_gate", up),
                                   ("fc_out", down))}


def _stack_t(ws):
    """(E, in, out) float32 numpy of HF (out, in) weights, stacked and
    transposed where they lie (on the card for tensors)."""
    if isinstance(ws[0], torch.Tensor):
        return _t(torch.stack([w.detach().float() for w in ws])
                  .transpose(1, 2).contiguous())
    return np.ascontiguousarray(np.stack([_t(w) for w in ws])
                                .transpose(0, 2, 1))


def _expert_mlp(experts):
    first, last = experts

    def moe(sd, p):
        held = [f"{p}mlp.experts.{e}." for e in range(first, last)]
        w = {name: _stack_t([sd[h + key + ".weight"] for h in held])
             for name, key in (("w1", "gate_proj"), ("w3", "up_proj"),
                               ("w2", "down_proj"))}
        E, F, D = len(held), w["w1"].shape[2], w["w2"].shape[2]
        return "moe", {"gate": _t(sd[p + "mlp.gate.weight"]).T, **w,
                       "b1": np.zeros((E, F), np.float32),
                       "b3": np.zeros((E, F), np.float32),
                       "b2": np.zeros((E, D), np.float32)}

    return moe


def convert_llama_state_dict(state_dict, n_layers: int) -> dict:
    """HF LlamaForCausalLM / Qwen3ForCausalLM (or the bare model) state
    dict -> the flax params tree of ``TransformerLM``: with ``lm_head``
    when the checkpoint has its own decoder, else for the tied decoder
    (an ``lm_head.weight`` equal to the embedding counts as tied)."""
    return _convert(state_dict, n_layers, _dense_mlp)


def _convert(state_dict, n_layers: int, ffn) -> dict:
    """The tree of :func:`convert_llama_state_dict`, each layer's
    feed-forward by ``ffn(sd, prefix)`` -> (its name, its tree)."""
    sd = dict(state_dict)
    head = None
    if any(k.startswith("model.") for k in sd):
        if "lm_head.weight" in sd:
            head = _t(sd["lm_head.weight"])
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    if head is not None and np.array_equal(
            head, _t(sd["embed_tokens.weight"])):
        head = None
    params: dict = {"word_embed": _t(sd["embed_tokens.weight"]),
                    "ln_f": {"scale": _t(sd["norm.weight"])}}
    if head is not None:
        params["lm_head"] = head

    def _b(key, width):
        # biases where the checkpoint has them, zeros otherwise (exact)
        return _t(sd[key]) if key in sd else np.zeros(width, np.float32)

    for i in range(n_layers):
        p = f"layers.{i}."
        q = _t(sd[p + "self_attn.q_proj.weight"]).T       # (D, H*hd)
        k = _t(sd[p + "self_attn.k_proj.weight"]).T       # (D, Hkv*hd)
        v = _t(sd[p + "self_attn.v_proj.weight"]).T
        o = _t(sd[p + "self_attn.o_proj.weight"]).T       # (H*hd, D)
        attn = {
            "qkv": {"kernel": np.concatenate([q, k, v], axis=1),
                    "bias": np.concatenate([
                        _b(p + "self_attn.q_proj.bias", q.shape[1]),
                        _b(p + "self_attn.k_proj.bias", k.shape[1]),
                        _b(p + "self_attn.v_proj.bias", v.shape[1])])},
            "out": {"kernel": o,
                    "bias": _b(p + "self_attn.o_proj.bias", o.shape[1])},
        }
        if p + "self_attn.q_norm.weight" in sd:
            attn["q_norm"] = {"scale": _t(sd[p + "self_attn.q_norm.weight"])}
            attn["k_norm"] = {"scale": _t(sd[p + "self_attn.k_norm.weight"])}
        name, tree = ffn(sd, p)
        params[f"block_{i}"] = {
            "ln1": {"scale": _t(sd[p + "input_layernorm.weight"])},
            "ln2": {"scale": _t(sd[p + "post_attention_layernorm.weight"])},
            "attn": attn, name: tree,
        }
    return params


def convert_qwen3_moe_state_dict(state_dict, n_layers: int,
                                 experts) -> dict:
    """HF Qwen3MoeForCausalLM state dict -> the flax params tree of an
    expert ``TransformerLM`` holding ``experts`` = (first, last) (see the
    module's doc); every layer an expert layer."""
    return _convert(state_dict, n_layers, _expert_mlp(experts))


def _build(params, **cfg):
    model = TransformerLM(pad_token=0, pos_embedding="rope", mlp="swiglu",
                          norm="rmsnorm", tied_decoder="lm_head" not in params,
                          **cfg)
    return load_jax_params(model, params), params


def load_llama(state_dict, n_layers: int, n_heads: int, d_model: int,
               vocab_size: int, n_kv_heads: int = 0, d_ff: int = 0,
               max_len: int = 4096, rope_base: float = 10000.0,
               norm_eps: float = 1e-5, drop: float = 0.0, **model_kw):
    """The port's TransformerLM of an HF Llama checkpoint, filled: returns
    (model, params), params the flax tree it was filled from.  The
    arguments are the HF config's num_hidden_layers, num_attention_heads,
    hidden_size, vocab_size, num_key_value_heads, intermediate_size,
    max_position_embeddings, rope_theta, rms_norm_eps; ``model_kw`` goes
    to TransformerLM (``device=``, ``flash_attention=``, ``rope_scaling=``,
    ...)."""
    return _build(convert_llama_state_dict(state_dict, n_layers),
                  vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
                  n_kv_heads=n_kv_heads, n_layers=n_layers, d_ff=d_ff,
                  max_len=max_len, drop=drop, rope_base=rope_base,
                  norm_eps=norm_eps, **model_kw)


def load_qwen3(state_dict, n_layers: int, n_heads: int, d_model: int,
               vocab_size: int, head_dim: int, n_kv_heads: int = 0,
               d_ff: int = 0, max_len: int = 4096,
               rope_base: float = 1000000.0, norm_eps: float = 1e-6,
               drop: float = 0.0, **model_kw):
    """HF Qwen3ForCausalLM -> (model, params), as :func:`load_llama` with
    ``qk_norm`` (the q_norm / k_norm leaves beside the fused qkv) and the
    config's ``head_dim``."""
    with tracing.span("convert.load_qwen3"):
        return _build(convert_llama_state_dict(state_dict, n_layers),
                      vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
                      n_kv_heads=n_kv_heads, n_layers=n_layers, d_ff=d_ff,
                      max_len=max_len, drop=drop, rope_base=rope_base,
                      norm_eps=norm_eps, head_dim=head_dim, qk_norm=True,
                      **model_kw)


def load_qwen3_moe(state_dict, n_layers: int, n_heads: int, d_model: int,
                   vocab_size: int, head_dim: int, n_experts: int,
                   moe_top_k: int, d_ff: int, n_kv_heads: int = 0,
                   moe_experts=None, max_len: int = 4096,
                   rope_base: float = 1000000.0, norm_eps: float = 1e-6,
                   drop: float = 0.0, **model_kw):
    """HF Qwen3MoeForCausalLM -> (model, params), as :func:`load_qwen3`
    with every layer's MLP a dropless top-``moe_top_k`` ``MoEMLP`` of the
    router's ``n_experts`` (``num_experts``, ``num_experts_per_tok``;
    ``d_ff`` is ``moe_intermediate_size``) holding ``moe_experts`` =
    (first, last), all by default: the state dict needs only the held
    experts' weights."""
    experts = tuple(moe_experts or (0, n_experts))
    with tracing.span("convert.load_qwen3_moe"):
        return _build(
            convert_qwen3_moe_state_dict(state_dict, n_layers, experts),
            vocab_size=vocab_size, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv_heads, n_layers=n_layers, d_ff=d_ff,
            max_len=max_len, drop=drop, rope_base=rope_base,
            norm_eps=norm_eps, head_dim=head_dim, qk_norm=True,
            n_experts=n_experts, moe_top_k=moe_top_k, moe_every=1,
            moe_experts=experts, **model_kw)


def _moe_config(cfg) -> dict:
    """load_qwen3_moe's expert arguments from a Qwen3-MoE or Mellum config:
    every layer an expert layer, weights renormalised over the top k."""
    if (cfg.get("decoder_sparse_step", 1) != 1
            or cfg.get("mlp_only_layers")
            or any(t != "sparse" for t in cfg.get("mlp_layer_types", ()))):
        raise NotImplementedError(
            "load_llama_dir: expert models with dense layers "
            "(decoder_sparse_step != 1, mlp_only_layers, or a mlp_layer_types"
            " entry that is not 'sparse') are not ported yet (ROADMAP "
            "Queue 1)")
    if not cfg.get("norm_topk_prob", False):
        raise NotImplementedError(
            "load_llama_dir: Qwen3-MoE without norm_topk_prob is not ported "
            "yet (ROADMAP Queue 1)")
    return dict(n_experts=cfg["num_experts"],
                moe_top_k=cfg["num_experts_per_tok"],
                d_ff=cfg["moe_intermediate_size"])


def _layer_types(cfg, hd: int) -> dict:
    """``window_pattern`` of a config that names each layer's attention
    (``layer_types``: 'sliding_attention' sees the last ``sliding_window``
    keys, 'full_attention' all) and, where its ``rope_parameters`` are
    given by layer type (Mellum: YaRN on the full layers only), the
    ``rope_pattern`` of each layer's own rotary phases."""
    kinds = cfg["layer_types"][:cfg["num_hidden_layers"]]
    windows = {"sliding_attention": int(cfg.get("sliding_window") or 0),
               "full_attention": 0}
    odd = sorted(set(kinds) - set(windows))
    if odd:
        raise NotImplementedError(
            f"load_llama_dir: layer_types {odd} are not ported yet (ROADMAP "
            f"Queue 1)")
    out = {"window_pattern": tuple(windows[k] for k in kinds)}
    by_type = cfg.get("rope_parameters") or {}
    if set(kinds) <= set(by_type):
        max_pos = int(cfg["max_position_embeddings"])
        ropes = {k: (float(r["rope_theta"]), rope_scaling_tuple(
            r, hd, float(r["rope_theta"]), max_pos))
            for k, r in by_type.items()}
        out["rope_pattern"] = tuple(ropes[k] for k in kinds)
    return out


def load_config(cfg: dict, state_dict, max_len: int = 0, **model_kw):
    """(model, params) of an HF ``config.json``'s dict and a state dict of
    its weights (numpy arrays or tensors), as :func:`load_llama_dir`
    builds them."""
    mt = cfg.get("model_type")
    if mt not in ("llama", "qwen3", "qwen3_moe", "mellum"):
        raise NotImplementedError(
            f"load_llama_dir: model_type {mt!r} is not ported yet (ROADMAP "
            f"Queue 1); 'llama', 'qwen3', 'qwen3_moe' and 'mellum' are")
    moe = _moe_config(cfg) if mt in ("qwen3_moe", "mellum") else None
    hd = cfg.get("head_dim") or (cfg["hidden_size"]
                                 // cfg["num_attention_heads"])
    prf = float(cfg.get("partial_rotary_factor", 1.0))
    if prf != 1.0:
        model_kw.setdefault("rotary_dim", int(hd * prf))
    common = dict(
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads", 0) or 0,
        d_model=cfg["hidden_size"],
        d_ff=cfg.get("intermediate_size", 0) or 0,
        vocab_size=cfg["vocab_size"],
        max_len=max_len or cfg.get("max_position_embeddings", 4096),
        rope_base=float(cfg.get("rope_theta", 10000.0)),
        norm_eps=float(cfg.get("rms_norm_eps", 1e-5)))
    if cfg.get("rope_scaling"):
        # the attention factor uses the config's max_position_embeddings
        # (HF semantics) even when max_len bounds the KV cache
        model_kw["rope_scaling"] = rope_scaling_tuple(
            cfg["rope_scaling"], hd, common["rope_base"],
            int(cfg.get("max_position_embeddings", common["max_len"])),
            original_max=int(
                cfg.get("original_max_position_embeddings", 0)))
    window = int(cfg.get("sliding_window") or 0)
    if "layer_types" in cfg:
        model_kw.update(_layer_types(cfg, hd))
    elif window and cfg.get("use_sliding_window") is not False:
        model_kw.setdefault("window", window)
    if mt != "llama":
        common["rope_base"] = float(cfg.get("rope_theta", 1000000.0))
        common["norm_eps"] = float(cfg.get("rms_norm_eps", 1e-6))
    if moe is not None:
        return load_qwen3_moe(state_dict, head_dim=hd,
                              **dict(common, **moe), **model_kw)
    if mt == "qwen3":
        return load_qwen3(state_dict, head_dim=hd, **common, **model_kw)
    return load_llama(state_dict, **common, **model_kw)


def load_llama_dir(path: str, max_len: int = 0, **model_kw):
    """(model, params) of an HF snapshot directory (``config.json`` and
    ``.safetensors``, one file or index-sharded) of ``model_type``
    'llama', 'qwen3', 'qwen3_moe' or 'mellum' (the two expert models with
    every layer an expert layer, the top-k weights renormalised;
    ``moe_experts=`` picks the held experts), read by
    ``utils.safetensors_io``.  ``max_len`` defaults to the config's
    max_position_embeddings; ``rope_scaling``, ``partial_rotary_factor``
    and a sliding window (where ``use_sliding_window`` is not False) are
    read from the config, or, where it has ``layer_types`` (Mellum), each
    layer's window and rotary phases (``window_pattern``,
    ``rope_pattern``); ``model_kw`` goes to TransformerLM.  Other model
    types, and expert models with dense layers, raise
    NotImplementedError.  Mellum's weights carry Qwen3-MoE's names, q/k
    norms included."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    return load_config(cfg, load_safetensors_auto(path), max_len, **model_kw)
