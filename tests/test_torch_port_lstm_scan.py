"""Port of ops/pallas_lstm.py: the LSTM scan op against the JAX Pallas
kernels run in interpret mode on the CPU.

On CPU tensors the port's ``lstm_scan`` runs its plain versions
(``reference_lstm_fwd``/``reference_lstm_bwd``) inside the same autograd
Function that launches K6/K7 on the card.  Both packages round xp, w_hh,
the stored ys/cs/gates and (backward) dgates to bf16 at the same places and
keep the carry in float32; only the order of the float32 sums differs (JAX
pads H to 128 lanes and B to 8 rows).  A bf16 value that rounds the other
way under that reordering moves by one bf16 ulp, 2**-8 relative; so bf16
outputs are held to atol 4e-3 (one ulp at magnitude 1) and float32 outputs
and gradients to 1e-4, against values of order 1.  At these sizes the
measured differences are at float32 round-off (below 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.ops import pallas_lstm as jax_lstm
from neuralnetworklibrary_tpu_torch.ops.lstm_scan import (
    lstm_bwd,
    lstm_fwd,
    lstm_scan,
    reference_lstm_bwd,
    reference_lstm_fwd,
)

BF16_TOL = 4e-3
F32_TOL = 1e-4


def _case(B, T, H, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 0.5, (B, T, 4 * H)).astype(np.float32),
            rng.normal(0, 0.2, (H, 4 * H)).astype(np.float32),
            rng.normal(0, 0.3, (B, H)).astype(np.float32),
            rng.normal(0, 0.3, (B, H)).astype(np.float32))


def _jax_scan(xp, w, h0, c0):
    return [np.asarray(a) for a in jax_lstm.lstm_scan(
        jnp.asarray(xp), jnp.asarray(w), jnp.asarray(h0), jnp.asarray(c0),
        True)]


def _port_scan(xp, w, h0, c0):
    return [a.detach().numpy() for a in lstm_scan(
        *(torch.from_numpy(a) for a in (xp, w, h0, c0)))]


@pytest.mark.parametrize("B,T,H", [(4, 6, 16), (3, 5, 24), (8, 9, 20)])
def test_forward_matches_pallas(B, T, H):
    """ys, hT, cT; B 3 is no multiple of 8 (the JAX batch pad), H 20 and
    24 no multiple of 128 (its lane pad)."""
    case = _case(B, T, H, seed=B * 100 + H)
    want = _jax_scan(*case)
    got = _port_scan(*case)
    for g, w, name, tol in zip(got, want, ("ys", "hT", "cT"),
                               (BF16_TOL, F32_TOL, F32_TOL)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)


def test_ys_are_bf16_rounded_in_xp_dtype():
    xp, w, h0, c0 = _case(3, 4, 8, seed=5)
    ys, hT, _ = lstm_scan(*(torch.from_numpy(a) for a in (xp, w, h0, c0)))
    assert ys.dtype == hT.dtype == torch.float32
    assert torch.equal(ys, ys.to(torch.bfloat16).float())


def test_carry_chains_like_pallas():
    """Two windows with the carry handed over equal one long window, in
    the port exactly (the carry is the same float32), and against JAX's
    chained windows within the stated tolerance."""
    xp, w, h0, c0 = _case(3, 8, 16, seed=1)
    full = _port_scan(xp, w, h0, c0)
    a = _port_scan(xp[:, :4], w, h0, c0)
    b = _port_scan(xp[:, 4:], w, a[1], a[2])
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]], 1), full[0])
    np.testing.assert_array_equal(b[1], full[1])
    ja = _jax_scan(xp[:, :4], w, h0, c0)
    jb = _jax_scan(xp[:, 4:], w, ja[1], ja[2])
    np.testing.assert_allclose(np.concatenate([a[0], b[0]], 1),
                               np.concatenate([ja[0], jb[0]], 1), rtol=0,
                               atol=BF16_TOL)
    np.testing.assert_allclose(b[2], jb[2], rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("B,T,H", [(3, 5, 8), (8, 7, 24)])
def test_plain_forward_matches_fwd_call(B, T, H):
    """reference_lstm_fwd against the Pallas _fwd_call on the same bf16
    time-major inputs: ys, cs, gates, hT, cT."""
    xp, w, h0, c0 = _case(B, T, H, seed=7)
    xp_tm = np.swapaxes(xp, 0, 1).copy()
    want = jax_lstm._fwd_call(jnp.asarray(xp_tm, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16), jnp.asarray(h0),
                              jnp.asarray(c0), interpret=True)
    got = reference_lstm_fwd(*(torch.from_numpy(a)
                               for a in (xp_tm, w, h0, c0)))
    for g, wv, name in zip(got, want, ("ys", "cs", "gates", "hT", "cT")):
        wv = np.asarray(wv.astype(jnp.float32))
        tol = BF16_TOL if g.dtype == torch.bfloat16 else F32_TOL
        np.testing.assert_allclose(g.float().numpy(), wv, rtol=0, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("B,T,H", [(3, 5, 8), (8, 6, 24)])
def test_plain_backward_matches_bwd_call(B, T, H):
    """reference_lstm_bwd against the Pallas _bwd_call on identical
    residuals (those of the forward above): dgates, dh0, dc0."""
    xp, w, h0, c0 = _case(B, T, H, seed=11)
    rng = np.random.default_rng(12)
    xp_tm = torch.from_numpy(np.swapaxes(xp, 0, 1).copy())
    ys, cs, gates, _, _ = reference_lstm_fwd(
        xp_tm, torch.from_numpy(w), torch.from_numpy(h0),
        torch.from_numpy(c0))
    cprev = torch.cat([torch.from_numpy(c0).to(torch.bfloat16)[None],
                       cs[:-1]])
    wT = torch.from_numpy(w).to(torch.bfloat16).t().contiguous()
    dys = rng.normal(0, 1, (T, B, H)).astype(np.float32)
    dhT = rng.normal(0, 1, (B, H)).astype(np.float32)
    dcT = rng.normal(0, 1, (B, H)).astype(np.float32)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(
            jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)

    want = jax_lstm._bwd_call(j(wT), j(gates), j(cs), j(cprev),
                              jnp.asarray(dys), jnp.asarray(dhT),
                              jnp.asarray(dcT), interpret=True)
    got = reference_lstm_bwd(wT, gates, cs, cprev, torch.from_numpy(dys),
                             torch.from_numpy(dhT), torch.from_numpy(dcT))
    for g, wv, name in zip(got, want, ("dgates", "dh0", "dc0")):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=0,
                                   atol=F32_TOL, err_msg=name)


def test_gradients_match_pallas():
    """dxp, dw, dh0, dc0 through the port's autograd Function and through
    the JAX custom VJP, for one loss over ys, hT and cT."""
    import jax

    case = _case(3, 5, 8, seed=2)

    def jloss(xp, w, h0, c0):
        ys, hT, cT = jax_lstm.lstm_scan(xp, w, h0, c0, True)
        return jnp.sum(ys * jnp.cos(ys)) + jnp.sum(hT) + 0.5 * jnp.sum(cT)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, case))
    ts = [torch.tensor(a, requires_grad=True) for a in case]
    ys, hT, cT = lstm_scan(*ts)
    ((ys * torch.cos(ys)).sum() + hT.sum() + 0.5 * cT.sum()).backward()
    for t, wv, name in zip(ts, want, ("dxp", "dw", "dh0", "dc0")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(wv), rtol=0,
                                   atol=F32_TOL, err_msg=name)


def test_kernel_wrappers_take_only_cuda_tensors():
    """The kernel wrappers never run a plain version: a CPU tensor raises
    before anything is built."""
    xp, w, h0, c0 = (torch.from_numpy(a) for a in _case(2, 3, 8, seed=3))
    xp_tm = xp.transpose(0, 1).to(torch.bfloat16).contiguous()
    wb = w.to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_fwd(xp_tm, wb, h0, c0)
    ys, cs, gates, _, _ = reference_lstm_fwd(xp_tm, wb, h0, c0)
    with pytest.raises(ValueError, match="CUDA"):
        lstm_bwd(wb.t().contiguous(), gates, cs, cs, ys.float(), h0, c0)


@pytest.mark.parametrize("bad", ["w", "h0", "xp"])
def test_lstm_scan_rejects_bad_shapes(bad):
    xp, w, h0, c0 = (torch.from_numpy(a) for a in _case(2, 3, 8, seed=4))
    args = {"xp": xp, "w": w, "h0": h0, "c0": c0}
    args[bad] = {"w": w[:, :-4], "h0": h0[:1], "xp": xp[..., :-1]}[bad]
    with pytest.raises(ValueError, match="do not fit"):
        lstm_scan(args["xp"], args["w"], args["h0"], args["c0"])
