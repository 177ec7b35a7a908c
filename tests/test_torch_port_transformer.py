"""Port of nn/transformer: TransformerLM logits against the JAX model after
load_jax_params, at atol 1e-5 in float32 (the same weights and inputs; the
two differ in summation order and in flax LayerNorm's mean(x^2) - mean(x)^2
variance, about 1e-7 here).  Covers the full-sequence forward, dense
prefill plus decode steps at shared and per-row offsets, and paged decode
through the kernel wrapper and through the gather path, for MHA, GQA,
sliding windows, sinks and RMSNorm.  Also the parameter loader's checks,
the device default, and that the port imports no JAX."""

import functools
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.nn.transformer import TransformerLM as JaxLM
from neuralnetworklibrary_tpu.nn.transformer import init_cache as jax_cache
from neuralnetworklibrary_tpu_torch.nn.transformer import (
    TransformerLM,
    init_cache,
)
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params

ROOT = Path(__file__).resolve().parent.parent
V = 64
BASE = dict(vocab_size=V, d_model=32, n_heads=4, n_layers=2, max_len=64)
CONFIGS = {
    "mha": {},
    "gqa": {"n_kv_heads": 2},
    "window": {"window": 5},
    "gqa_window": {"n_kv_heads": 2, "window": 5},
    "gqa_sinks": {"n_kv_heads": 2, "sinks": True},
    "rmsnorm": {"norm": "rmsnorm"},
}
ATOL = 1e-5


def _jax_model(kw, **extra):
    """(JAX model, its params, the params as a numpy tree)."""
    jm = JaxLM(**BASE, drop=0.0, **kw, **extra)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    return jm, params, jax.tree_util.tree_map(np.asarray, params)


def _port(tree, kw, **extra):
    return load_jax_params(TransformerLM(**BASE, **kw, **extra,
                                         device="cpu"), tree)


def _pair(kw, **extra):
    """(JAX model, its params, port model on cpu with the same weights)."""
    jm, params, tree = _jax_model(kw, **extra)
    return jm, params, _port(tree, kw, **extra)


def _close(jax_logits, port_logits):
    np.testing.assert_allclose(port_logits.detach().numpy(),
                               np.asarray(jax_logits), rtol=0, atol=ATOL)


# decode inputs: (tokens, offsets or None) per call
DENSE_STEPS = [(slice(0, 7), None), (slice(7, 8), None), (slice(8, 9), None),
               # rows at their own positions: row 1 rewinds to position 5
               (slice(9, 10), [9, 5]), (slice(10, 11), [10, 6])]
PAGED = dict(paged_kv_blocks=12, paged_kv_block=8)
TABLE = np.asarray([[3, 7, 1, 0, 0, 0, 0, 0],
                    [2, 9, 11, 5, 4, 0, 0, 0]], np.int32)
PAGED_OFF = np.asarray([6, 29], np.int32)
PAGED_STEPS = 3


@functools.lru_cache(maxsize=None)
def _jax_run(name: str, kind: str):
    """The JAX model's logits for one config, computed once and shared by
    the tests that compare port paths against it: kind 'dense' (prefill
    and decode steps) or 'paged' (decode steps, Pallas kernel in interpret
    mode).  Returns (numpy params tree, [logits per call], [tokens])."""
    extra = PAGED | {"paged_attention": True} if kind == "paged" else {}
    jm, params, tree = _jax_model(CONFIGS[name], **extra)
    step = jax.jit(functools.partial(jm.apply, decode=True,
                                     mutable=["cache"]))
    cache = jax_cache(jm, 2)
    rng = np.random.default_rng(2)
    outs, toks = [], []
    if kind == "dense":
        x = rng.integers(0, V, (2, 12))
        for sl, off in DENSE_STEPS:
            kw = {} if off is None else {
                "offsets": jnp.asarray(off, jnp.int32)}
            out, mut = step({"params": params, "cache": cache},
                            jnp.asarray(x[:, sl]), **kw)
            cache = mut["cache"]
            outs.append(np.asarray(out[0]))
            toks.append(x[:, sl])
    else:
        for t in range(PAGED_STEPS):
            x = rng.integers(0, V, (2, 1))
            out, mut = step({"params": params, "cache": cache},
                            jnp.asarray(x),
                            offsets=jnp.asarray(PAGED_OFF + t),
                            block_table=jnp.asarray(TABLE))
            cache = mut["cache"]
            outs.append(np.asarray(out[0]))
            toks.append(x)
    return tree, outs, toks


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_forward(name):
    jm, params, pm = _pair(CONFIGS[name])
    x = np.random.default_rng(1).integers(0, V, (2, 12))
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))[0]
    _close(want, pm(torch.as_tensor(x))[0])


@pytest.mark.parametrize("name", ["gqa", "gqa_window", "mha", "window"])
def test_dense_prefill_then_decode(name):
    """Prefill 7 tokens, 2 steps on the shared counter, then 2 steps at
    per-row offsets (the serving engine's form).  Sinks and RMSNorm take
    no decode-specific code, and the other tests cover them."""
    tree, outs, toks = _jax_run(name, "dense")
    pm = _port(tree, CONFIGS[name])
    pc = init_cache(pm, 2)
    for (sl, off), want, x in zip(DENSE_STEPS, outs, toks):
        kw = {} if off is None else {
            "offsets": torch.as_tensor(off, dtype=torch.int32)}
        _close(want, pm(torch.as_tensor(x), decode=True, cache=pc, **kw)[0])
        if off is None:
            assert pc["idx"] == sl.stop


@pytest.mark.parametrize("kernel", [True, False], ids=["kernel", "gather"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_paged_decode(name, kernel):
    """Paged decode steps from empty pools at per-row offsets, against the
    JAX paged model running its Pallas kernel in interpret mode."""
    tree, outs, toks = _jax_run(name, "paged")
    pm = _port(tree, CONFIGS[name], **PAGED, paged_attention=kernel)
    pc = init_cache(pm, 2)
    for t, (want, x) in enumerate(zip(outs, toks)):
        _close(want, pm(torch.as_tensor(x), decode=True, cache=pc,
                        offsets=torch.as_tensor(PAGED_OFF + t),
                        block_table=torch.as_tensor(TABLE))[0])


def test_paged_cache_needs_block_table():
    _, _, pm = _pair({}, **PAGED)
    with pytest.raises(ValueError, match="block_table"):
        pm(torch.zeros(1, 1, dtype=torch.long), decode=True,
           cache=init_cache(pm, 1), offsets=torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="cache"):
        pm(torch.zeros(1, 1, dtype=torch.long), decode=True)


def test_paged_model_prefills_through_a_dense_cache():
    """init_cache(paged=False) on a paged model gives dense strips; a
    dense model refuses a paged cache."""
    _, _, pm = _pair({}, **PAGED)
    dense = init_cache(pm, 1, paged=False)
    assert dense["block_0"]["attn"]["k"].shape == (1, 64, 4, 8)
    assert init_cache(pm, 3)["block_1"]["attn"]["pool_v"].shape == (12, 8,
                                                                      4, 8)
    _, _, plain = _pair({})
    with pytest.raises(ValueError, match="paged_kv_blocks"):
        init_cache(plain, 1, paged=True)


def _tree():
    jm = JaxLM(**BASE, drop=0.0)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def test_load_rejects_missing_key():
    tree = _tree()
    del tree["block_1"]["mlp"]["fc_out"]["bias"]
    with pytest.raises(ValueError, match=r"missing \['block_1.mlp.fc_out"):
        load_jax_params(TransformerLM(**BASE, device="cpu"), tree)


def test_load_rejects_extra_key():
    tree = _tree()
    tree["block_0"]["attn"]["sink"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match=r"extra \['block_0.attn.sink"):
        load_jax_params(TransformerLM(**BASE, device="cpu"), tree)


def test_load_rejects_wrong_shape():
    tree = _tree()
    tree["pos_embed"] = np.zeros((32, 32), np.float32)
    with pytest.raises(ValueError, match="pos_embed"):
        load_jax_params(TransformerLM(**BASE, device="cpu"), tree)


def test_load_transposes_dense_kernels():
    tree = _tree()
    pm = load_jax_params(TransformerLM(**BASE, device="cpu"), tree)
    np.testing.assert_array_equal(
        pm.block_0.attn.qkv.weight.detach().numpy(),
        tree["block_0"]["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(pm.ln_f.weight.detach().numpy(),
                                  tree["ln_f"]["scale"])


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**BASE)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, imports with jax
    blocked and leaves no module of the JAX package loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("jax", "jaxlib", "flax"):
            sys.modules[name] = None
        import neuralnetworklibrary_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names + ["chip_smoke"]:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "neuralnetworklibrary_tpu"
               or m.startswith("neuralnetworklibrary_tpu.")]
        assert not bad, bad
        assert len(names) >= 10, names
        print("ok", len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
