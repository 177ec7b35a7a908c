"""Mellum 2 decoders (HF ``model_type`` 'mellum': Qwen3-MoE's layout with
each layer's attention sliding-window or full, and rotary phases by layer
type) as the port trains one pipeline stage of them: random HF-layout
weights of the held experts and vocabulary rows from the seed, built by
``utils.llama_convert.load_config`` (the path of ``load_llama_dir``, which
reads ``layer_types``, ``sliding_window`` and ``rope_parameters`` into the
model's ``window_pattern`` and ``rope_pattern``) into ``TransformerLM``
(flash attention, packed rows restarting after the separator, every layer
a dropless top-k ``MoEMLP``), the packed cross-entropy, and the names
that tie the port's leaves to the reference's (Qwen3-MoE's).

The port's converter gives the attention's ``nn.Linear`` layers and the
experts zero biases, which Mellum lacks; they stay frozen
(:func:`trainable`).
"""

from __future__ import annotations

from portbench.families import qwen3_moe
# the harness trains this family's plain reference as ``family.reference``
from portbench.reference import mellum as reference

KERNELS = ("flash_attention",)   # the port's kernel sources it runs
leaf_map, port_layout, trainable, loss_func = (
    qwen3_moe.leaf_map, qwen3_moe.port_layout, qwen3_moe.trainable,
    qwen3_moe.loss_func)


def _check(cfg):
    first, last = cfg["deployment"]["held_experts"]
    if last - first != cfg["num_experts"]:
        raise ValueError("num_experts counts the held experts")
    if cfg["tie_word_embeddings"] or cfg["attention_bias"]:
        raise ValueError("this family file covers untied, bias-free Mellum")
    if (cfg["hidden_act"] != "silu" or not cfg["norm_topk_prob"]
            or len(cfg["layer_types"]) != cfg["num_hidden_layers"]
            or cfg["mlp_layer_types"] != ["sparse"] * len(
                cfg["layer_types"])):
        raise ValueError("this family file covers SwiGLU experts in every "
                         "layer, renormalised top-k, one type a layer")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Qwen3-MoE's HF state dict of the held experts and vocabulary rows
    (``families/qwen3_moe.py``, one device draw from ``seed``): the layer
    types change no weight."""
    _check(cfg)
    return qwen3_moe.make_weights(dict(cfg, decoder_sparse_step=1,
                                       mlp_only_layers=[], rope_scaling=None),
                                  seed, device)


def build(cfg: dict, weights: dict, device):
    """The port's model of these weights, by the converter a user calls."""
    from neuralnetworklibrary_tpu_torch.utils.llama_convert import (
        load_config,
    )

    model, _ = load_config(
        cfg, weights, moe_experts=tuple(cfg["deployment"]["held_experts"]),
        flash_attention=True, reset_at=cfg["bench"]["separator"],
        device=device)
    return model


def dims(cfg: dict) -> dict:
    """:func:`qwen3_moe.dims` and each layer's window (``windows``: 0 on a
    full layer), which the attention readers split the layers by."""
    return dict(qwen3_moe.dims(cfg),
                windows=[reference.window(cfg, i)
                         for i in range(cfg["num_hidden_layers"])])
