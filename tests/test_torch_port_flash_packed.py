"""The flash op's packed-row and sink options against the JAX package on
the CPU: ``ops.flash_attention.flash_attention`` with ``q_start`` (alone,
with a causal window, a key mask that masks a document's every key, and a
bias with its gradient) and ``sink`` (causal, bidirectional, with
q_start), outputs and the gradients of q, k, v, bias and sink against
``jax.grad`` of the JAX ``flash_attention`` (its Pallas kernels in
interpret mode); and the plain dk/dv/dbias pass that the card's kernels
are held to (``reference_dkv_dbias`` with ``qs``) against autograd.

A row whose every visible key is masked is left out of the comparison
with JAX: the JAX kernel then spreads the row over every key of the tiles
it visits and its einsum reference over all T keys, while the port's
plain version (which the card's kernels follow) spreads it over the keys
of the row's own document up to its position
(``test_fully_masked_document_row``).

Tolerance: 1e-5 of the largest entry of each output (float32 sums in
other orders; the sink's gradient sums B*T rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.ops import flash_attention as jfa
from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa

B, T, H, HD = 2, 128, 2, 32


def _starts(rng, lengths_per_row):
    return np.stack([np.repeat(np.cumsum([0] + ls[:-1]), ls)
                     for ls in lengths_per_row]).astype(np.int32)


STARTS = [[5, 59, 1, 1, 1, 61], [128]], [[1] * 40 + [70, 18], [64, 64]]


def _close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()),
                               err_msg=name)


@pytest.mark.parametrize("case", ["q_start", "window", "kv_mask", "bias",
                                  "sink", "sink_bidirectional",
                                  "sink_q_start"])
def test_options_match_jax(case):
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    q, k, v, do = (rng.standard_normal((B, T, H, HD)).astype(np.float32)
                   for _ in range(4))
    kw = {"causal": case != "sink_bidirectional"}
    if case in ("q_start", "window", "kv_mask", "bias", "sink_q_start"):
        kw["q_start"] = _starts(rng, STARTS[case == "bias"])
    if case == "window":
        kw["window"] = 16
    if case == "kv_mask":
        m = rng.random((B, T)) < 0.7
        # each document's first key stays, so no row loses every key
        m[np.arange(B)[:, None], kw["q_start"]] = True
        kw["kv_mask"] = m
    if case == "bias":
        kw["bias"] = (rng.standard_normal((H, T, T)) * 0.5).astype(
            np.float32)
    if case.startswith("sink"):
        kw["sink"] = (rng.standard_normal(H) * 2).astype(np.float32)
    diff = [n for n in ("bias", "sink") if n in kw]

    def jfn(q_, k_, v_, *opts):
        o = jfa.flash_attention(q_, k_, v_, **{**kw, **dict(zip(diff,
                                                                  opts))})
        return jnp.sum(o * do), o

    (_, jo), jg = jax.value_and_grad(
        jfn, argnums=tuple(range(3 + len(diff))), has_aux=True)(
        q, k, v, *(kw[n] for n in diff))
    tx = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    topts = {n: torch.from_numpy(kw[n]).requires_grad_() for n in diff}
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    o = fa.flash_attention(*tx, **{**tkw, **topts})
    grads = torch.autograd.grad(o, tx + list(topts.values()),
                                torch.from_numpy(do))
    _close(o, jo, "o")
    for name, g, w in zip(["dq", "dk", "dv"] + diff, grads, jg):
        _close(g, w, name)


def test_plain_dkv_dbias_pass_takes_q_start():
    """The plain version of K3's pass (what the card's K3 and K4 are held
    to, from the saved lse and delta) with document starts equals autograd
    of the plain forward: dk, dv, and dbias as its dS summed over b."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B, T, H, HD)).astype(np.float32)) for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((H, T, T)).astype(
        np.float32)).requires_grad_()
    qs = torch.from_numpy(_starts(rng, STARTS[0]))
    xs = [t.clone().requires_grad_() for t in (q, k, v)]
    scale = HD ** -0.5
    o, lse = fa.reference_flash_attention(*xs, scale, bias=bias,
                                          q_start=qs, return_lse=True)
    _, dk, dv, dbias = torch.autograd.grad(o, xs + [bias], do)
    delta = (do * o.detach()).sum(-1).transpose(1, 2).reshape(B * H, T)
    gk, gv, gb = fa.flash_bwd_dkv_dbias(
        q, k, v, do, lse.detach().reshape(B * H, T), delta, scale,
        bias=bias.detach(), qs=qs)
    for name, g, w in (("dk", gk, dk), ("dv", gv, dv), ("dbias", gb, dbias)):
        _close(g, w.numpy(), name)


def test_fully_masked_document_row():
    """With q_start, a query whose document's keys up to it are all masked
    attends uniformly over exactly those keys (the kernels' 1/n rule with
    the document start), and its gradient reaches no q or k."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, T, H, HD)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    qs = torch.from_numpy(_starts(rng, [[5, 59, 64]]))
    m = torch.ones(1, T, dtype=torch.bool)
    m[0, 5:64] = False
    o = fa.flash_attention(q, k, v, q_start=qs, kv_mask=m)
    for t in (5, 20, 63):
        torch.testing.assert_close(o[0, t], v[0, 5:t + 1].mean(0))
    dq, dk = torch.autograd.grad(o[0, 5:64].sum(), (q, k))
    assert float(dq.abs().max()) == 0.0 and float(dk.abs().max()) == 0.0


def test_option_checks():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="requires causal"):
        fa.flash_attention(q, q, q, causal=False,
                           q_start=torch.zeros(1, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="q_start must be"):
        fa.flash_attention(q, q, q, q_start=torch.zeros(1, 7))
    with pytest.raises(ValueError, match="sink must be"):
        fa.flash_attention(q, q, q, sink=torch.zeros(3))
