"""Port of ops/paged_attention: the PyTorch plain version (what the wrapper
runs for CPU tensors, and what the CUDA kernel is held against on the card
by chip_smoke.py) against the JAX package's Pallas kernel in interpret mode
and its gather oracle, over the parametrisation of
tests/test_paged_attention.py, and at head dims only the plain version
takes.  Tolerance rtol = atol = 2e-5 in float32: the two sides differ only
in summation order.  Also the wrapper's errors, and the kernel build's
refusal where nvcc is missing."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.ops.paged_attention import (
    paged_attention as jax_paged_attention,
)
from neuralnetworklibrary_tpu.ops.paged_attention import (
    reference_paged_attention as jax_reference,
)
from neuralnetworklibrary_tpu_torch.kernels import build
from neuralnetworklibrary_tpu_torch.ops.paged_attention import (
    _launch,
    paged_attention,
    reference_paged_attention,
)

TOL = dict(rtol=2e-5, atol=2e-5)
_jax_kernel = jax.jit(jax_paged_attention, static_argnames=("window",))
_jax_ref = jax.jit(jax_reference, static_argnames=("window",))


def _case(seed, B, H, Hkv, hd, N, bs, MB, quant=False, share=False):
    """numpy inputs, made as tests/test_paged_attention.py makes them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (B, H, hd)).astype(np.float32)
    if quant:
        pk = rng.integers(-127, 128, (N, bs, Hkv, hd)).astype(np.int8)
        pv = rng.integers(-127, 128, (N, bs, Hkv, hd)).astype(np.int8)
        sk = rng.uniform(0.001, 0.02, (N, bs, Hkv)).astype(np.float32)
        sv = rng.uniform(0.001, 0.02, (N, bs, Hkv)).astype(np.float32)
    else:
        pk = rng.normal(0, 1, (N, bs, Hkv, hd)).astype(np.float32)
        pv = rng.normal(0, 1, (N, bs, Hkv, hd)).astype(np.float32)
        sk = sv = None
    if share:
        shared = rng.choice(np.arange(1, N), MB // 2, replace=False)
        table = np.stack([np.concatenate([
            shared, rng.choice(np.arange(1, N), MB - MB // 2, replace=False),
        ]) for _ in range(B)])
    else:
        table = rng.choice(np.arange(1, N), (B, MB), replace=False)
    off = rng.integers(0, MB * bs, (B,))
    return dict(q=q, pool_k=pk, pool_v=pv, block_table=table.astype(np.int32),
                offsets=off.astype(np.int32), pool_k_scale=sk,
                pool_v_scale=sv)


def _both(case, **kw):
    """(port plain version, JAX interpret-mode kernel, JAX oracle)."""
    tt = {k: None if v is None else torch.from_numpy(np.asarray(v))
          for k, v in case.items()}
    jj = {k: None if v is None else jnp.asarray(v) for k, v in case.items()}
    tkw = dict(kw)
    jkw = dict(kw)
    if kw.get("sink") is not None:
        tkw["sink"] = torch.from_numpy(kw["sink"])
        jkw["sink"] = jnp.asarray(kw["sink"])
    got = paged_attention(**tt, **tkw).numpy()
    return (got, np.asarray(_jax_kernel(**jj, **jkw)),
            np.asarray(_jax_ref(**jj, **jkw)))


def _check(case, **kw):
    got, kern, ref = _both(case, **kw)
    np.testing.assert_allclose(got, kern, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("H,Hkv,hd", [(4, 4, 32), (8, 2, 16), (6, 1, 8)])
def test_matches_jax(H, Hkv, hd):
    _check(_case(0, B=5, H=H, Hkv=Hkv, hd=hd, N=40, bs=8, MB=4))


@pytest.mark.parametrize("off", [[0, 0, 0, 0], [7, 8, 15, 16],
                                 [23, 23, 23, 23]])
def test_offset_edges(off):
    """off = 0, on a block boundary, and at the last position."""
    case = _case(1, B=4, H=4, Hkv=2, hd=16, N=32, bs=8, MB=3)
    case["offsets"] = np.asarray(off, np.int32)
    _check(case)


@pytest.mark.parametrize("window", [1, 5, 8, 17])
def test_window(window):
    _check(_case(2, B=4, H=4, Hkv=4, hd=16, N=40, bs=8, MB=4),
           window=window)


def test_quantized_pools():
    _check(_case(3, B=4, H=8, Hkv=2, hd=16, N=40, bs=8, MB=4, quant=True))


def test_shared_rows_and_trash_tails():
    """Prefix-shared tables and short offsets whose tail entries are trash
    row 0, as the engine leaves them."""
    case = _case(4, B=6, H=4, Hkv=2, hd=16, N=48, bs=8, MB=4, share=True)
    off = np.asarray([3, 9, 20, 0, 31, 12], np.int32)
    for b in range(6):
        case["block_table"][b, off[b] // 8 + 1:] = 0
    case["offsets"] = off
    _check(case)


def test_scalar_offsets():
    case = _case(5, B=3, H=4, Hkv=2, hd=16, N=24, bs=8, MB=2)
    case["offsets"] = np.asarray(11, np.int32)
    _check(case)


@pytest.mark.parametrize("window", [0, 6])
def test_sink(window):
    """The sink joins only the normalizer: the output changes, and matches
    the JAX kernel's max-folded form."""
    case = _case(6, B=3, H=4, Hkv=2, hd=32, N=20, bs=8, MB=4)
    sink = np.random.default_rng(7).normal(size=4).astype(np.float32)
    _check(case, sink=sink, window=window)
    base, _, _ = _both(case, window=window)
    got, _, _ = _both(case, sink=sink, window=window)
    assert np.abs(got - base).max() > 1e-4


def test_scale_default():
    case = _case(8, B=2, H=2, Hkv=2, hd=16, N=16, bs=8, MB=2)
    tt = {k: None if v is None else torch.from_numpy(np.asarray(v))
          for k, v in case.items()}
    a = paged_attention(**tt, sm_scale=1 / math.sqrt(16))
    b = paged_attention(**tt)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_matches_jax_reference():
    """bf16 inputs: both sides round at other places; 2e-2, as the JAX
    package's own bf16 test."""
    case = _case(9, B=3, H=4, Hkv=4, hd=32, N=24, bs=8, MB=2)
    tt = {k: None if v is None else torch.from_numpy(np.asarray(v))
          for k, v in case.items()}
    for k in ("q", "pool_k", "pool_v"):
        tt[k] = tt[k].to(torch.bfloat16)
    got = paged_attention(**tt)
    assert got.dtype == torch.bfloat16
    jj = {k: None if v is None else jnp.asarray(v) for k, v in case.items()}
    for k in ("q", "pool_k", "pool_v"):
        jj[k] = jj[k].astype(jnp.bfloat16)
    want = np.asarray(jax_reference(**jj), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_reference_is_the_cpu_path():
    """On CPU tensors the wrapper IS the plain version and launches
    nothing."""
    case = _case(10, B=3, H=4, Hkv=2, hd=16, N=24, bs=8, MB=3)
    tt = {k: None if v is None else torch.from_numpy(np.asarray(v))
          for k, v in case.items()}
    before = paged_attention.launches
    a = paged_attention(**tt, window=5)
    b = reference_paged_attention(**tt, window=5)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert paged_attention.launches == before


@pytest.mark.parametrize("H,Hkv,hd,quant,match", [
    (6, 4, 16, False, "multiple of Hkv"),
    (4, 4, 12, False, "multiple of 8"),
    (2, 2, 264, False, "<= 256"),
    (4, 2, 16, True, "int8 pools need"),
])
def test_wrapper_errors(H, Hkv, hd, quant, match):
    """Shapes the function does not take raise on every device.  The CUDA
    kernel's own limits on hd (a multiple of 8, at most 256) raise at its
    entry, before any launch, while the plain version on the CPU computes
    any hd, as JAX's does (test_any_head_dim_on_cpu)."""
    q = torch.zeros(2, H, hd)
    dt = torch.int8 if quant else torch.float32
    pool = torch.zeros(5, 4, Hkv, hd, dtype=dt)
    table = torch.ones(2, 2, dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    if match in ("multiple of 8", "<= 256"):
        with pytest.raises(ValueError, match=match):
            _launch(q, pool, pool, table, off, splits=1)
        assert paged_attention(q, pool, pool, table, off).shape == q.shape
        return
    with pytest.raises(ValueError, match=match):
        paged_attention(q, pool, pool, table, off)


@pytest.mark.parametrize("hd", [12, 264])
def test_any_head_dim_on_cpu(hd):
    """The plain version takes head dims the kernel does not, against
    JAX's kernel (interpret mode) and oracle."""
    _check(_case(11, B=3, H=4, Hkv=2, hd=hd, N=16, bs=8, MB=3), window=6)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Where no CUDA toolkit is found, building raises instead of
    returning something that is not the kernel."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["paged_attention"])


def test_build_lists_the_kernel_sources():
    assert "paged_attention" in build.sources()
    flags = " ".join(build.FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
