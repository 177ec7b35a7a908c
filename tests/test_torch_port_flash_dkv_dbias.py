"""The plain version of K3 with K4 folded in (``reference_dkv_dbias``: dk,
dv and each batch row's dS from the saved lse and delta, what the CUDA
pass computes) and its batch sum (``flash_bwd_dkv_dbias`` on CPU tensors)
against ``jax.grad`` of the JAX ``flash_attention`` in interpret mode, at
B 3 with a batch-shared bias, a ragged key mask and one batch row whose
keys are all masked; bidirectional, and causal with dropout (the same
hash mask in both packages).

The fully masked row is held against the JAX einsum reference instead:
its forward attends uniformly in both packages, but the JAX kernel's
backward takes p = exp(s - lse) = 1 for each of its keys there (lse is
-1e30), so its dv is T times the mean of dO and its dk and dbias are not
0.  The port gives the reference's gradient (p = 1/n, no gradient through
a masked key), so its dbias is the JAX kernel's over the other rows.

Tolerance: atol 2e-5 in float32 on dk, dv of order 1 (the two sum in
different orders); dbias, a sum over the batch of such terms, 4e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from neuralnetworklibrary_tpu.ops.flash_attention import (
    reference_attention as jax_reference,
)
from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
    dbias_rows,
    flash_bwd_dkv_dbias,
    reference_dkv_dbias,
    reference_flash_attention,
)

ATOL = 2e-5
B, T, H, HD = 3, 48, 2, 16
CASES = {"bidirectional": dict(causal=False),
         "causal_dropout": dict(causal=True, dropout=0.1, dropout_seed=-77)}


def _inputs(seed=31):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((B, T, H, HD)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.standard_normal((1, H, T, T)) * 0.5).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([T, T // 2 + 5, 0])[:, None]
    return q, k, v, do, bias, mask


def _port_grads(q, k, v, do, bias, mask, causal, dropout=0.0,
                dropout_seed=0):
    """The port's forward (plain, with lse), delta from its o, then the
    fused backward on CPU tensors: dk, dv, dbias, and the per-row dS."""
    qt, kt, vt, dot = (torch.tensor(a) for a in (q, k, v, do))
    bias_t, mask_t = torch.tensor(bias[0]), torch.tensor(mask)
    scale = HD ** -0.5
    o, lse = reference_flash_attention(
        qt, kt, vt, scale, 0, causal, dropout, dropout_seed, bias=bias_t,
        kv_mask=mask_t, return_lse=True)
    delta = (dot * o).sum(-1).transpose(1, 2).reshape(B * H, T)
    kvm = torch.zeros(B, T).masked_fill(~mask_t, -1e30)
    args = (qt, kt, vt, dot, lse.reshape(B * H, T), delta, scale, 0,
            dropout, dropout_seed)
    kw = dict(causal=causal, bias=bias_t, kvm=kvm)
    dk, dv, dbias = flash_bwd_dkv_dbias(*args, **kw)
    ds = reference_dkv_dbias(*args, **kw)[2]
    return dk, dv, dbias, ds


def _jax_grads(fn, q, k, v, do, bias, mask, rows, **kw):
    """jax.grad of sum(fn(...) * do) over batch rows ``rows``: dk, dv,
    dbias (H, T, T)."""
    def loss(k_, v_, b_):
        return jnp.sum(fn(jnp.asarray(q[rows]), k_, v_, bias=b_,
                          kv_mask=jnp.asarray(mask[rows]), **kw) * do[rows])

    gk, gv, gb = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(k[rows]), jnp.asarray(v[rows]), jnp.asarray(bias))
    return np.asarray(gk), np.asarray(gv), np.asarray(gb)[0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_partials_then_batch_sum_match_jax_flash(name):
    kw = CASES[name]
    q, k, v, do, bias, mask = _inputs()
    dk, dv, dbias, ds = _port_grads(q, k, v, do, bias, mask, **kw)
    # rows 0 and 1 (ragged): the JAX kernel, in the batch of 3 and alone
    gk, gv, _ = _jax_grads(jax_flash, q, k, v, do, bias, mask, slice(None),
                           **kw)
    gb = _jax_grads(jax_flash, q, k, v, do, bias, mask, slice(0, 2), **kw)[2]
    np.testing.assert_allclose(dk[:2].numpy(), gk[:2], rtol=0, atol=ATOL,
                               err_msg="dk")
    np.testing.assert_allclose(dv[:2].numpy(), gv[:2], rtol=0, atol=ATOL,
                               err_msg="dv")
    np.testing.assert_allclose(dbias.numpy(), gb, rtol=0, atol=2 * ATOL,
                               err_msg="dbias")
    # row 2 (every key masked): the JAX reference
    rk, rv, _ = _jax_grads(
        lambda *a, dropout=0.0, dropout_seed=None, **k: jax_reference(*a, **k),
        q, k, v, do, bias, mask, slice(2, 3), **kw)
    if "dropout" not in kw:
        np.testing.assert_allclose(dv[2:].numpy(), rv, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rk, 0.0)
    assert not dk[2].any() and not ds[2].any()
    # the batch sum is of the per-row partials; masked keys get nothing
    assert ds.shape == (B, H, T, T)
    torch.testing.assert_close(dbias, ds.sum(0), rtol=0, atol=0)
    assert not dk[1, T // 2 + 5:].any() and not dv[1, T // 2 + 5:].any()


def test_fully_masked_row_gives_dv_the_mean_of_do():
    """The row whose keys are all masked attends uniformly (p = 1/n over
    the keys its position sees): bidirectional, dv = sum over queries of
    dO / T."""
    q, k, v, do, bias, mask = _inputs(32)
    dv = _port_grads(q, k, v, do, bias, mask, causal=False)[1]
    np.testing.assert_allclose(dv[2].numpy(),
                               np.broadcast_to(do[2].sum(0) / T, (T, H, HD)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("T_, rows", [(1, 64), (64, 64), (65, 128),
                                      (114, 128), (512, 512), (1000, 1024)])
def test_dbias_scratch_rows(T_, rows):
    assert dbias_rows(T_) == rows


def test_fused_backward_needs_the_bias():
    q = torch.zeros(1, 8, 1, 64)
    lse = torch.zeros(1, 8)
    with pytest.raises(ValueError, match="needs the bias"):
        flash_bwd_dkv_dbias(q, q, q, q, lse, lse, 0.125, bias=None)
