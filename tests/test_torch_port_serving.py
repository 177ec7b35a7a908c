"""Port of serving/engine.py and serving/paged.py: greedy emissions of the
PyTorch ServingEngine and PagedServingEngine are token-exact against the
JAX engines on the request mixes of tests/test_paged.py (mixed lengths,
chunked decode, slot reuse, a pool small enough to force preemption), and
their scheduling stats are equal.  The paged port runs both its kernel
wrapper and its gather path.  Sampled streams (k > 1) differ from JAX's by
design, so they are checked for reproducibility and for per-request
overrides only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neuralnetworklibrary_tpu import serving as jax_serving
from neuralnetworklibrary_tpu.nn.transformer import TransformerLM as JaxLM
from neuralnetworklibrary_tpu_torch import serving
from neuralnetworklibrary_tpu_torch.nn.transformer import TransformerLM
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params

V = 50
CFG = dict(vocab_size=V, d_model=32, n_heads=4, n_layers=2, max_len=64)
STATS = ("decode_steps", "prefills", "prefill_tokens", "slot_steps_active",
         "slot_steps_total", "sat_slot_steps_active", "sat_slot_steps_total")
PAGED_STATS = STATS + ("preemptions", "blocks_peak")

# name: (param seed, request seed, waves of (prompt len, max_new[, rep]),
#        paged model kwargs or None for dense, engine kwargs)
SCENARIOS = {
    "dense_chunked": (2, 3, [[(5, 8), (11, 6), (4, 10), (17, 5), (9, 9),
                              (2, 12)]],
                      None, dict(slots=3, chunk=4, prompt_buckets=(8, 32))),
    "paged_chunked_penalty": (
        2, 3, [[(5, 8, 1.5), (11, 6), (4, 10, 1.5), (17, 5), (9, 9, 1.3),
                (2, 12)]],
        dict(paged_kv_blocks=40, paged_kv_block=8),
        dict(slots=3, chunk=4, prompt_buckets=(8, 32))),
    "paged_mixed_reuse": (
        4, 5, [[(3, 6), (13, 9), (7, 4), (20, 12), (5, 7)],
               [(6, 7), (12, 5), (3, 9)], [(6, 7), (12, 5), (3, 9)]],
        dict(paged_kv_blocks=24, paged_kv_block=8),
        dict(slots=2, prompt_buckets=(8, 16, 32))),
    "paged_preemption": (
        6, 7, [[(20, 30), (18, 28), (16, 26)]],
        dict(paged_kv_blocks=13, paged_kv_block=8),
        dict(slots=3, prompt_buckets=(8, 32))),
}


def _waves(mod, seed, waves):
    rng = np.random.default_rng(seed)
    return [[mod.Request(rng.integers(0, V, spec[0]).tolist(), spec[1],
                         repetition_penalty=spec[2] if len(spec) > 2
                         else None)
             for spec in wave] for wave in waves]


def _engine_cls(mod, paged):
    return mod.PagedServingEngine if paged else mod.ServingEngine


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX engine results of a scenario: (params tree, [(tokens per
    request, stats, free blocks) per wave])."""
    pseed, rseed, waves, paged, ekw = SCENARIOS[name]
    jm = JaxLM(**CFG, drop=0.0, **(paged or {}))
    params = jm.init(jax.random.PRNGKey(pseed),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    eng = _engine_cls(jax_serving, paged)(jm, params, **ekw)
    out = []
    for reqs in _waves(jax_serving, rseed, waves):
        eng.run(reqs)
        out.append(([r.tokens for r in reqs], dict(eng.stats),
                    len(getattr(eng, "_free", []))))
    return jax.tree_util.tree_map(np.asarray, params), out


def _port_run(name, kernel=True):
    pseed, rseed, waves, paged, ekw = SCENARIOS[name]
    tree, _ = _jax_run(name)
    pm = load_jax_params(TransformerLM(**CFG, **(paged or {}),
                                       paged_attention=kernel, device="cpu"),
                         tree)
    eng = _engine_cls(serving, paged)(pm, **ekw)
    out = []
    for reqs in _waves(serving, rseed, waves):
        eng.run(reqs)
        assert all(r.finished for r in reqs)
        out.append(([r.tokens for r in reqs], dict(eng.stats),
                    len(getattr(eng, "_free", []))))
    return out


@pytest.mark.parametrize("name,kernel", [
    (name, kernel) for name in sorted(SCENARIOS)
    for kernel in ((True, False) if SCENARIOS[name][3] else (True,))])
def test_greedy_token_exact(name, kernel):
    """kernel=False runs the paged port through its gather path."""
    _, want = _jax_run(name)
    got = _port_run(name, kernel)
    for wave, ((gt, _, _), (wt, _, _)) in enumerate(zip(got, want)):
        assert gt == wt, f"wave {wave}"


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_stats_equal(name):
    keys = STATS if SCENARIOS[name][3] is None else PAGED_STATS
    _, want = _jax_run(name)
    got = _port_run(name)
    for wave, ((_, gs, gfree), (_, ws, wfree)) in enumerate(zip(got, want)):
        assert {k: gs[k] for k in keys} == {k: ws[k] for k in keys}, wave
        assert gfree == wfree
    if name == "paged_preemption":
        assert got[-1][1]["preemptions"] > 0
    if name == "paged_mixed_reuse":   # every block back after each wave
        assert got[-1][2] == SCENARIOS[name][3]["paged_kv_blocks"] - 1


def _tiny(seed=0, **kw):
    jm = JaxLM(**CFG, drop=0.0)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    return load_jax_params(TransformerLM(**CFG, **kw, device="cpu"),
                           jax.tree_util.tree_map(np.asarray, params))


def test_sampling_reproducible_and_overridable():
    """Sampled runs repeat under one seed; a k=1 request inside a sampled
    batch emits exactly its greedy tokens; tokens stay in the vocab."""
    pm = _tiny(paged_kv_blocks=30, paged_kv_block=8)
    spec = [(6, 9), (11, 7), (4, 8)]

    def run(seed, first_k=None, **ekw):
        rng = np.random.default_rng(1)
        reqs = [serving.Request(rng.integers(0, V, p).tolist(), n)
                for p, n in spec]
        reqs[0].k = first_k
        serving.PagedServingEngine(pm, slots=2, seed=seed,
                                   prompt_buckets=(8, 16), **ekw).run(reqs)
        return [r.tokens for r in reqs]

    sampled = dict(k=8, temperature=1.5, top_p=0.95)
    a = run(0, **sampled)
    assert a == run(0, **sampled)
    assert all(0 <= t < V for toks in a for t in toks)
    greedy = run(0)
    assert run(3, first_k=1, **sampled)[0] == greedy[0]
    assert a != greedy


def test_engine_guards():
    paged = _tiny(paged_kv_blocks=12, paged_kv_block=8)
    dense = _tiny()
    with pytest.raises(ValueError, match="paged_kv_blocks"):
        serving.PagedServingEngine(dense)
    with pytest.raises(ValueError, match="PagedServingEngine"):
        serving.ServingEngine(paged)
    with pytest.raises(ValueError, match="exceed"):
        serving.PagedServingEngine(_tiny(paged_kv_blocks=8,
                                         paged_kv_block=8))
    with pytest.raises(ValueError, match="chunk"):
        serving.ServingEngine(dense, chunk=0)
    with pytest.raises(ValueError, match="top_p"):
        serving.ServingEngine(dense, top_p=0.0)
    with pytest.raises(ValueError, match="max_new"):
        serving.Request([1, 2], 0)
    with pytest.raises(ValueError, match="room to decode"):
        serving.ServingEngine(dense).run([serving.Request([1] * 64, 2)])


def test_stop_sequence_and_streaming():
    """A stop sequence ends a request (and is kept); on_token streams every
    kept token in order."""
    pm = _tiny()
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, V, 9).tolist()
    free = serving.Request(prompt, 12)
    serving.ServingEngine(pm, slots=1, prompt_buckets=(16,)).run([free])
    stop = free.tokens[3:5]
    req = serving.Request(prompt, 12, stop_sequences=[stop])
    seen = []
    eng = serving.ServingEngine(pm, slots=1, chunk=4, prompt_buckets=(16,))
    eng.run([req], on_token=lambda r, t: seen.append(t))
    first = next(i for i in range(1, len(free.tokens))
                 if free.tokens[i - 1:i + 1] == stop)
    assert req.tokens == free.tokens[:first + 1]
    assert seen == req.tokens
    assert 0 < eng.occupancy <= 1
