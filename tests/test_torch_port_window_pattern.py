"""Sliding-window and full attention by layer, each layer with its own rotary
phases (Mellum 2): the port's ``TransformerLM(window_pattern=...,
rope_pattern=...)`` and ``load_llama_dir`` for ``model_type`` 'mellum' on
the CPU.

- a 4-layer packed decoder (d 64, 4 heads of 16 over 2, layers [8, 8, 8,
  0], T 64, two document starts a row, so windows cross them) against
  the JAX package's ``window_pattern`` on shared weights, both attention
  paths: logits, loss and every gradient;
- the rotary phases of a layer pattern with YaRN on one layer only,
  against the plain reference (``portbench/reference/mellum.py``);
- ``load_llama_dir`` on a written Mellum config and state dict against
  that reference: loss and every gradient, both attention paths; a
  ``dense`` ``mlp_layer_types`` entry raises;
- the flash calls' attended-pair counters against a host count.

Tolerances as ``test_torch_port_qwen3.py``: logits and gradients 1e-5 of
their largest entry (float32 sums in other orders), the loss 1e-6
relative against JAX and 1e-5 against the reference (its experts are
added one at a time, the port's in one grouped product).
"""

import functools
import json
import os

os.environ.setdefault("USE_TF", "0")   # transformers without TensorFlow

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from neuralnetworklibrary_tpu.nn import transformer as jtr  # noqa: E402
from neuralnetworklibrary_tpu_torch.nn import transformer as tr  # noqa
from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa  # noqa
from neuralnetworklibrary_tpu_torch.utils import llama_convert as conv  # noqa
from neuralnetworklibrary_tpu_torch.utils import tracing  # noqa: E402
from neuralnetworklibrary_tpu_torch.utils.jax_params import (  # noqa: E402
    _flatten,
    _torch_name,
    load_jax_params,
)
from neuralnetworklibrary_tpu_torch.utils.safetensors_io import (  # noqa
    save_safetensors,
)
from portbench import harness  # noqa: E402
from portbench.families import mellum as fam  # noqa: E402
from portbench.reference import mellum as ref  # noqa: E402
from portbench.reference.common import doc_starts  # noqa: E402

V, EOS, PAD, T, W = 50, 0, 1, 64, 8
CFG = dict(vocab_size=V, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
           n_layers=4, d_ff=96, max_len=T, drop=0.0, pos_embedding="rope",
           rope_base=1e4, qk_norm=True, mlp="swiglu", norm="rmsnorm",
           reset_at=EOS, window_pattern=(W, W, W, 0))
YARN = {"rope_type": "yarn", "rope_theta": 5e5, "factor": 16,
        "original_max_position_embeddings": 16, "beta_fast": 32,
        "beta_slow": 1, "attention_factor": 1.2772588722239782}
TOL = 1e-5


def _close(got, want, name="", scale=None):
    want = np.asarray(want)
    atol = TOL * (np.abs(want).max() if scale is None else scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=max(atol, 1e-7), err_msg=name)


@functools.cache
def _rows():
    """Two rows of 64 whose documents start at 0, 21 and 46 (row 0) and
    0, 9 and 40 (row 1): windows of 8 cross each start."""
    rng = np.random.default_rng(1)
    raw = rng.integers(2, V, (2, T + 1))
    raw[0, [20, 45]] = EOS
    raw[1, [8, 39]] = EOS
    return raw[:, :-1], raw[:, 1:]


@functools.cache
def _jax():
    """The JAX model's params (moved off their init) and its einsum
    path's packed loss, logits and gradients."""
    jm = jtr.TransformerLM(**CFG, flash_attention=False)
    p = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(
            np.float32), p["params"])
    x, y = _rows()
    loss_fn = jtr.PackedSeqCrossEntropyLoss(PAD)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x))
        return loss_fn(out, jnp.asarray(y)), out[0]

    return params, jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)


@pytest.mark.parametrize("flash", [False, True])
def test_window_pattern_matches_jax(flash):
    """Both attention paths (einsum with the band and segment masks; the
    flash op with window and q_start, here its plain version) against the
    JAX model's einsum path: logits, loss and every gradient."""
    params, ((jl, jlogits), jg) = _jax()
    x, y = _rows()
    pm = load_jax_params(tr.TransformerLM(**CFG, flash_attention=flash,
                                          device="cpu"), params)
    assert [b.attn.window for b in pm.blocks()] == [W, W, W, 0]
    out = pm(torch.from_numpy(x).long())
    loss = tr.PackedSeqCrossEntropyLoss(PAD)(out, torch.from_numpy(y))
    loss.backward()
    _close(out[0].detach(), jlogits, "logits")
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    grads = dict(pm.named_parameters())
    flat = list(_flatten(jax.tree_util.tree_map(np.asarray, jg)))
    scale = max(np.abs(g).max() for _, g in flat)
    for name, g in flat:
        g = g.T if name.endswith(".kernel") else g
        _close(grads[_torch_name(name)].grad, g, name, scale)


def _mellum_cfg():
    """The cell's configuration at a tiny size: layers [sliding x 3,
    full], window 8, YaRN on the full layer only (original length 16, so
    it bends the phases inside T 64), 8 experts, top 3."""
    with open(f"{harness.ROOT}/portbench/configs/mellum2-12b-a2.5b.json") as f:
        cfg = json.load(f)
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, moe_intermediate_size=32, num_hidden_layers=4,
               vocab_size=V, max_position_embeddings=T, num_experts=8,
               num_experts_per_tok=3, sliding_window=W,
               rope_parameters={"full_attention": YARN,
                                "sliding_attention": {"rope_type": "default",
                                                      "rope_theta": 1e4}},
               bench={"separator": EOS, "pad": PAD, "token_ids": [2, V]})
    cfg["deployment"] = dict(cfg["deployment"], held_experts=[0, 8],
                             router_experts=8)
    return cfg


def test_rope_pattern_gives_each_layer_its_own_phases():
    """A layer pattern of default phases and one YaRN layer: each block
    turns by its own (base, scaling), and the YaRN phases (with their
    attention factor) equal the reference's."""
    yarn = tr.rope_scaling_tuple(YARN, 16, 5e5, T)
    pm = tr.TransformerLM(**CFG, rope_pattern=(None, None, None,
                                               (5e5, yarn)), device="cpu")
    assert [(b.attn.rope_base, b.attn.rope_scaling) for b in pm.blocks()
            ] == [(1e4, None)] * 3 + [(5e5, yarn)]
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, T, 4, 16, generator=g)
    pos = torch.arange(T).expand(2, T) % 37
    for scaling, rp in ((yarn, YARN),
                        (None, {"rope_type": "default", "rope_theta": 5e5})):
        got = tr.rope(x, pos, 5e5, scaling)
        want = ref.turn(x, *ref.rope(pos, 16, rp))
        _close(got, want, str(scaling))
    with pytest.raises(ValueError, match="rope_pattern"):
        tr.TransformerLM(**CFG, rope_pattern=((5e5, yarn),), device="cpu")
    with pytest.raises(ValueError, match="window_pattern"):
        tr.TransformerLM(**dict(CFG, window_pattern=(W, 0)), device="cpu")


def _write(tmp_path, cfg, weights):
    keep = {k: v for k, v in cfg.items()
            if k not in ("family", "deployment", "assumed", "bench", "train",
                         "reduced", "source")}
    (tmp_path / "config.json").write_text(json.dumps(keep))
    save_safetensors({k: v.contiguous() for k, v in weights.items()},
                     str(tmp_path / "model.safetensors"))


@pytest.mark.parametrize("flash", [False, True])
def test_load_llama_dir_mellum_matches_the_reference(tmp_path, flash):
    """A written Mellum snapshot through ``load_llama_dir`` against the
    plain reference on packed rows whose windows cross document starts:
    loss and every gradient; a dense MLP layer type raises."""
    cfg = _mellum_cfg()
    weights = fam.make_weights(cfg, 3, "cpu")
    _write(tmp_path, cfg, weights)
    model, _ = conv.load_llama_dir(str(tmp_path), flash_attention=flash,
                                   reset_at=EOS, device="cpu")
    assert model.window_pattern == (W, W, W, 0)
    assert model.blocks()[3].attn.rope_scaling[0] == "yarn"
    assert model.blocks()[0].attn.rope_scaling is None
    x, y = (torch.from_numpy(a).long() for a in _rows())
    loss = fam.loss_func(cfg)(model(x, train=True), y)
    loss.backward()
    p = ref.params(weights)
    want = ref.loss(p, x, y, cfg, cfg["bench"], "float32")
    want.backward()
    assert abs(float(loss - want)) <= TOL * float(want)
    params = dict(model.named_parameters())
    for name, (port, rows) in fam.leaf_map(cfg).items():
        got = params[port].grad
        got = got if rows is None else got[rows[0]:rows[1]]
        _close(got, fam.port_layout(name, p[name].grad), name)
    (tmp_path / "config.json").write_text(json.dumps(dict(
        json.loads((tmp_path / "config.json").read_text()),
        mlp_layer_types=["sparse", "dense", "sparse", "sparse"])))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        conv.load_llama_dir(str(tmp_path), device="cpu")


@pytest.mark.parametrize("window, starts", [(0, False), (W, False),
                                            (W, True), (0, True)])
def test_pair_counters_count_the_attended_pairs(window, starts):
    """While tracing is on, each flash call adds its attended pairs of one
    head to its kind's counter (a window: sliding; none: full), as a host
    count over positions, window and document starts gives them."""

    def call(q, window, qs):
        return fa.flash_attention(q, q, q, window=window, q_start=qs)

    tracing.reset()
    q = torch.randn(2, T, 2, 16)
    qs = None
    if starts:
        qs = doc_starts(torch.from_numpy(_rows()[0]), EOS)
    before = {k: int(v) for k, v in fa.attended_pairs().items()}
    call(q, window, qs)   # tracing off
    tracing.enable()
    try:
        call(q, window, qs)
    finally:
        tracing.disable()
    got = {k: int(v) - before[k] for k, v in fa.attended_pairs().items()}
    lo = np.zeros((2, T), int) if qs is None else qs.numpy()
    t = np.arange(T)
    if window:
        lo = np.maximum(lo, t - window + 1)
    want = int((t - np.maximum(lo, 0) + 1).sum())
    kind = "sliding" if window else "full"
    assert got == {kind: want, ("full" if window else "sliding"): 0}
