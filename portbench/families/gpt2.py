"""GPT-2 as the port trains it: a random flax-layout tree from the seed,
``utils.jax_params.load_jax_params`` into ``TransformerLM`` (learned
positions, LayerNorm, tanh-GELU MLP, tied head, flash attention on the
plain causal path: a document separator inside a row is attended
across), and the sequence cross-entropy over every target.
"""

from __future__ import annotations

import torch

# the harness trains this family's plain reference as ``family.reference``
from portbench.reference import gpt2 as reference

LAYER_SHAPES = (("ln1/scale", ("D",), 1.0), ("ln1/bias", ("D",), 0.0),
                ("attn/qkv/kernel", ("D", "3D"), None),
                ("attn/qkv/bias", ("3D",), 0.0),
                ("attn/out/kernel", ("D", "D"), None),
                ("attn/out/bias", ("D",), 0.0),
                ("ln2/scale", ("D",), 1.0), ("ln2/bias", ("D",), 0.0),
                ("mlp/fc_in/kernel", ("D", "F"), None),
                ("mlp/fc_in/bias", ("F",), 0.0),
                ("mlp/fc_out/kernel", ("F", "D"), None),
                ("mlp/fc_out/bias", ("D",), 0.0))

KERNELS = ("flash_attention",)   # the port's kernel sources it runs


def _sizes(cfg):
    D = cfg["n_embd"]
    return {"D": D, "3D": 3 * D, "F": cfg.get("n_inner") or 4 * D}


def _check(cfg):
    if cfg["activation_function"] != "gelu_new":
        raise ValueError("this family file covers the tanh GELU")
    if len({cfg["attn_pdrop"], cfg["embd_pdrop"], cfg["resid_pdrop"]}) != 1:
        raise ValueError("the port takes one dropout rate")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """A flax-layout tree flattened with "/" on ``device``: every matrix
    and both embeddings normal(0, initializer_range) from one draw of a
    device generator seeded with ``seed``, biases 0, norm scales 1."""
    _check(cfg)
    s = _sizes(cfg)
    shapes = {"word_embed": (("V", "D"), None),
              "pos_embed": (("P", "D"), None),
              "ln_f/scale": (("D",), 1.0), "ln_f/bias": (("D",), 0.0)}
    s.update(V=cfg["vocab_size"], P=cfg["n_positions"])
    for i in range(cfg["n_layer"]):
        for name, dims_, fill in LAYER_SHAPES:
            shapes[f"block_{i}/{name}"] = (dims_, fill)
    shapes = {k: (tuple(s[d] for d in ds), fill)
              for k, (ds, fill) in shapes.items()}
    n = sum(shape[0] * shape[1] for shape, fill in shapes.values()
            if fill is None)
    g = torch.Generator(device).manual_seed(seed)
    flat = torch.empty(n, device=device)
    flat.normal_(0.0, cfg["initializer_range"], generator=g)
    out, at = {}, 0
    for k, (shape, fill) in shapes.items():
        if fill is not None:
            out[k] = torch.full(shape, fill, device=device)
            continue
        out[k] = flat[at:at + shape[0] * shape[1]].view(shape)
        at += shape[0] * shape[1]
    return out


def build(cfg: dict, weights: dict, device):
    """The port's model of these weights, filled by the flax-tree loader."""
    from neuralnetworklibrary_tpu_torch.nn.transformer import TransformerLM
    from neuralnetworklibrary_tpu_torch.utils.jax_params import (
        load_jax_params,
    )

    s = _sizes(cfg)
    model = TransformerLM(
        vocab_size=cfg["vocab_size"], d_model=s["D"], n_heads=cfg["n_head"],
        n_layers=cfg["n_layer"], max_len=cfg["n_positions"], d_ff=s["F"],
        drop=cfg["resid_pdrop"], norm_eps=cfg["layer_norm_epsilon"],
        flash_attention=True, device=device)
    tree = {}
    for k, v in weights.items():
        node = tree
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.cpu().numpy()
    return load_jax_params(model, tree)


def loss_func(cfg: dict):
    from neuralnetworklibrary_tpu_torch.applications.text import (
        SeqCrossEntropyLoss,
    )

    return SeqCrossEntropyLoss()


def trainable(cfg: dict, name: str) -> bool:
    return True


def leaf_map(cfg: dict) -> dict:
    """{reference leaf: (port leaf, rows)}: the reference holds q, k and v
    apart (``reference.gpt2.params``), the port in one ``qkv`` whose
    first axis (out features) stacks them; rows (start, end) of that
    axis, or None for the whole leaf.  Flax names map to the port's with
    kernel and scale as weight."""
    D = cfg["n_embd"]

    def port(name):
        head, _, leaf = name.rpartition("/")
        leaf = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
        return f"{head}.{leaf}".replace("/", ".") if head else leaf

    out = {n: (port(n), None) for n in ("word_embed", "pos_embed",
                                         "ln_f/scale", "ln_f/bias")}
    for i in range(cfg["n_layer"]):
        for name, _, _ in LAYER_SHAPES:
            full = f"block_{i}/{name}"
            if "/qkv/" not in name:
                out[full] = (port(full), None)
                continue
            for j, part in enumerate("qkv"):
                out[full.replace("/qkv/", f"/{part}/")] = (
                    port(full), (j * D, (j + 1) * D))
    return out


def port_layout(name: str, t):
    """A reference leaf's tensor in the port's layout: flax kernels are
    (in, out), the port's weights (out, in)."""
    return t.T.contiguous() if name.endswith("/kernel") else t


def dims(cfg: dict) -> dict:
    s = _sizes(cfg)
    per_layer = 4 * s["D"] * s["D"] + 2 * s["D"] * s["F"]
    return {"L": cfg["n_layer"], "H": cfg["n_head"], "Hkv": cfg["n_head"],
            "hd": s["D"] // cfg["n_head"], "separator": None,
            "n_matmul": cfg["n_layer"] * per_layer
            + cfg["vocab_size"] * s["D"]}
