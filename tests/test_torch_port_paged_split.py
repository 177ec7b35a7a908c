"""The split-sequence algorithm of the CUDA paged decode kernel, in plain
PyTorch (``split_paged_attention_reference``: S shares of each slot's live
range, cut at multiples of CHUNK positions, merged in order with the sink
at the merge), against the JAX package's Pallas kernel in interpret mode
and against the port's gather version, at atol 1e-5 in float32: the sides
differ only in the order of the sums.  Also the host's rule for S
(``num_splits``), which reads shapes and never the offsets."""

import inspect
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.ops.paged_attention import (
    CHUNK,
    num_splits,
    reference_paged_attention,
    split_paged_attention_reference,
)

TOL = dict(rtol=0, atol=1e-5)
_jax_kernel = jax.jit(jax_paged_attention, static_argnames=("window",))
# 16 blocks of 16 positions: 256 positions, 8 chunks of 32
B, N, BS, MB = 4, 70, 16, 16


def _case(seed, H, Hkv, hd, quant=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, hd)).astype(np.float32)
    if quant:
        pk = rng.integers(-127, 128, (N, BS, Hkv, hd)).astype(np.int8)
        pv = rng.integers(-127, 128, (N, BS, Hkv, hd)).astype(np.int8)
        sk = rng.uniform(0.001, 0.02, (N, BS, Hkv)).astype(np.float32)
        sv = rng.uniform(0.001, 0.02, (N, BS, Hkv)).astype(np.float32)
    else:
        pk = rng.normal(0, 1, (N, BS, Hkv, hd)).astype(np.float32)
        pv = rng.normal(0, 1, (N, BS, Hkv, hd)).astype(np.float32)
        sk = sv = None
    table = rng.choice(np.arange(1, N), (B, MB), replace=False)
    # offset 0, the end of a chunk, the start of the next, the last position
    off = np.asarray([0, 2 * CHUNK - 1, 2 * CHUNK, MB * BS - 1], np.int32)
    return dict(q=q, pool_k=pk, pool_v=pv, block_table=table.astype(np.int32),
                offsets=off, pool_k_scale=sk, pool_v_scale=sv)


_CASES = {"g1": (0, 4, 4, 16, False), "g4": (1, 8, 2, 16, False),
          "int8": (2, 8, 2, 16, True)}
_SINK = np.random.default_rng(9).normal(size=8).astype(np.float32)


def _run(name, splits, window=0, sink=False):
    """(split reference, JAX kernel, gather version) on case ``name``."""
    case = _case(*_CASES[name])
    H = case["q"].shape[1]
    tt = {k: None if v is None else torch.from_numpy(v)
          for k, v in case.items()}
    jj = {k: None if v is None else jnp.asarray(v) for k, v in case.items()}
    tkw, jkw = dict(window=window), dict(window=window)
    if sink:
        tkw["sink"] = torch.from_numpy(_SINK[:H])
        jkw["sink"] = jnp.asarray(_SINK[:H])
    got = split_paged_attention_reference(**tt, **tkw, splits=splits)
    with jax.default_matmul_precision("highest"):   # float32 dots
        kern = np.asarray(_jax_kernel(**jj, **jkw))
    return got.numpy(), kern, reference_paged_attention(**tt, **tkw).numpy()


@pytest.mark.parametrize("name", ["g1", "g4"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 20])
def test_split_matches_jax(name, splits):
    """S = 1 up to more shares than the live range has chunks (8 at most;
    the shares past them are empty), G 1 and 4, offsets 0, at a chunk edge
    and at the last position."""
    got, kern, ref = _run(name, splits)
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("window", [1, 5, 40])
def test_window_inside_one_share(window):
    """Windows that end inside one share of seven: the other shares of the
    slot are empty (-1e30, 0, 0) and drop out of the merge."""
    got, kern, ref = _run("g4", 7, window=window)
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("splits", [1, 3])
def test_int8_pools(splits):
    """k-scales on the scores, v-scales on p, l summing the unscaled p."""
    got, kern, ref = _run("int8", splits)
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("splits,window", [(1, 0), (7, 0), (7, 40)])
def test_sink_at_the_merge(splits, window):
    """The sink joins the normalizer once, after the shares merge."""
    got, kern, ref = _run("g4", splits, window=window, sink=True)
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
    base, _, _ = _run("g4", splits, window=window)
    assert np.abs(got - base).max() > 1e-4


def test_clamped_table_and_offsets():
    """Table entries and offsets out of range are clamped, as XLA clamps
    the TPU version's gather."""
    case = _case(*_CASES["g1"])
    tt = {k: None if v is None else torch.from_numpy(v)
          for k, v in case.items()}
    wild = dict(tt)
    wild["block_table"] = tt["block_table"].clone()
    wild["block_table"][:, 0] = -3
    wild["block_table"][:, 1] = N + 5
    wild["offsets"] = torch.tensor([0, 70, 130, 10_000], dtype=torch.int32)
    clamped = dict(tt)
    clamped["block_table"] = wild["block_table"].clamp(0, N - 1)
    clamped["offsets"] = wild["offsets"].clamp(max=MB * BS - 1)
    got = split_paged_attention_reference(**wild, splits=3)
    want = reference_paged_attention(**clamped)
    torch.testing.assert_close(got, want, **TOL)


def test_bf16_returns_q_dtype():
    case = _case(*_CASES["g4"])
    tt = {k: None if v is None else torch.from_numpy(v)
          for k, v in case.items()}
    for k in ("q", "pool_k", "pool_v"):
        tt[k] = tt[k].to(torch.bfloat16)
    got = split_paged_attention_reference(**tt, splits=3)
    assert got.dtype == torch.bfloat16
    want = reference_paged_attention(**{k: (v.float() if v is not None and
                                            v.is_floating_point() else v)
                                        for k, v in tt.items()})
    torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("units,positions,sm,per_sm,want", [
    (96, 1024, 132, 6, 8),       # GPT-2 serving, B 8: 96 blocks per share
    (384, 1024, 132, 6, 2),      # B 32
    (12, 1024, 132, 6, 16),      # B 1: shares of two chunks
    (128, 4096, 132, 2, 2),      # Llama-3-8B heads, B 16 (G 4, one block)
    (4, 64, 132, 2, 1),          # B 2, G 12: two blocks of heads per kv head
    (4, 256, 132, 2, 4),
    (6144, 1024, 132, 6, 1),     # more blocks than a wave: S 1
    (1, 1, 132, 6, 1),
])
def test_num_splits(units, positions, sm, per_sm, want):
    S = num_splits(units, positions, sm, per_sm)
    assert S == want
    assert 1 <= S <= max(1, positions // (2 * CHUNK))
    assert S == 1 or units * S <= sm * per_sm


def test_num_splits_reads_no_offsets():
    """S comes from ints the host holds: no tensor, no offsets, so the
    wrapper never waits on the card."""
    params = inspect.signature(num_splits).parameters
    assert list(params) == ["units", "positions", "sm_count",
                            "blocks_per_sm"]


def test_constants_match_the_kernel_source():
    src = (build.CSRC / "paged_attention.cu").read_text()
    assert int(re.search(r"constexpr int kChunk = (\d+);", src)
               .group(1)) == CHUNK
