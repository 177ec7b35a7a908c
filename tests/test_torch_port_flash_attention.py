"""Port of ops/flash_attention: the plain version (what the port runs on
CPU tensors, and what the CUDA kernels are held against on the card)
against the JAX ``flash_attention`` in interpret mode, forward output and
dq/dk/dv, for causal, windowed and dropout attention at a T that is no
multiple of 128; the T5 options (bidirectional, key mask, batch-shared
bias) with dbias, against JAX's flash in interpret mode once and against
``jax.grad`` of its einsum reference otherwise; the dropout keep mask bit
for bit against the JAX ``_drop_keep``; the other options against the JAX
einsum reference; and the model's flash dispatch.

Tolerance: atol 2e-5 in float32 on values of order 1 (the two sum in
different orders; the JAX kernel also scales q before its dot); dbias,
a sum over the batch of such terms, 4e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from neuralnetworklibrary_tpu.ops.flash_attention import _drop_keep
from neuralnetworklibrary_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from neuralnetworklibrary_tpu.ops.flash_attention import (
    reference_attention as jax_reference,
)
from neuralnetworklibrary_tpu_torch.nn.transformer import TransformerLM
from neuralnetworklibrary_tpu_torch.ops.flash_attention import (
    drop_keep,
    flash_attention,
    reference_flash_attention,
)

ATOL = 2e-5
B, H, HD = 1, 2, 16
CASES = {
    "causal": dict(T=256),
    "window": dict(T=256, window=37),
    "dropout": dict(T=256, dropout=0.1, dropout_seed=-1234567),
    "ragged_all": dict(T=200, window=70, dropout=0.1, dropout_seed=2 ** 31 - 5),
}


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, HD)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_forward_and_grads(name):
    kw = dict(CASES[name])
    T = kw.pop("T")
    q, k, v, do = _inputs(T)

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, **kw) * do)

    o_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    grads_j = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o_t = flash_attention(qt, kt, vt, **kw)
    (o_t * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=0, atol=ATOL)
    for got, want, n in zip((qt.grad, kt.grad, vt.grad), grads_j, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=f"d{n}")


T5_CASES = {
    # JAX's flash kernels in interpret mode: the T5 encoder's options
    "bidir_mask_bias_interpret": dict(T=128, causal=False, mask=True,
                                      interpret=True),
    "causal_bias": dict(T=100, causal=True, mask=False),
    "bidir_mask_bias": dict(T=77, causal=False, mask=True),
    "causal_mask_bias_dropout": dict(T=90, causal=True, mask=True,
                                     dropout=0.1),
}


@pytest.mark.parametrize("name", sorted(T5_CASES))
def test_t5_options_match_jax_with_dbias(name):
    """Forward and dq, dk, dv, dbias with a (1, H, T, T) bias and a ragged
    key mask; dropout against the JAX flash (its mask is the same hash)."""
    kw = dict(T5_CASES[name])
    T, causal = kw.pop("T"), kw.pop("causal")
    interpret = kw.pop("interpret", False) or "dropout" in kw
    rng = np.random.default_rng(21)
    q, k, v, do = (rng.standard_normal((2, T, H, HD)).astype(np.float32)
                   for _ in range(4))
    bias = (rng.standard_normal((1, H, T, T)) * 0.5).astype(np.float32)
    mask = None
    if kw.pop("mask"):
        mask = np.arange(T)[None, :] < np.array([T, T // 2 + 3])[:, None]
    extra = {}
    if "dropout" in kw:
        extra = dict(dropout=kw["dropout"], dropout_seed=-77)

    def jfn(a, b, c, bb):
        m = None if mask is None else jnp.asarray(mask)
        if interpret:
            return jax_flash(a, b, c, causal=causal, bias=bb, kv_mask=m,
                             **extra)
        return jax_reference(a, b, c, causal=causal, bias=bb, kv_mask=m)

    ja = [jnp.asarray(a) for a in (q, k, v, bias)]
    o_j = jfn(*ja)
    grads_j = jax.grad(lambda *a: jnp.sum(jfn(*a) * do),
                       argnums=(0, 1, 2, 3))(*ja)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    o_t = flash_attention(*ts[:3], causal=causal, bias=ts[3],
                          kv_mask=None if mask is None
                          else torch.tensor(mask), **extra)
    (o_t * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j),
                               rtol=0, atol=ATOL)
    for t, want, n, atol in zip(ts, grads_j, ("q", "k", "v", "bias"),
                                (ATOL, ATOL, ATOL, 2 * ATOL)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=0,
                                   atol=atol, err_msg=f"d{n}")
    if mask is not None:   # masked keys get exactly zero dk, dv, dbias
        assert not ts[1].grad[1, T // 2 + 3:].any()
        assert not ts[2].grad[1, T // 2 + 3:].any()


def test_fully_masked_row_attends_uniformly():
    """A batch row whose keys are all masked gets the mean of v over its
    keys, as JAX's reference and kernels give (bidirectional); no gradient
    reaches q, k or the bias through it, and dv is dO / T."""
    rng = np.random.default_rng(22)
    q, k, v, do = (rng.standard_normal((2, 40, H, HD)).astype(np.float32)
                   for _ in range(4))
    bias = rng.standard_normal((H, 40, 40)).astype(np.float32)
    mask = np.ones((2, 40), bool)
    mask[1] = False
    want = jax_reference(*(jnp.asarray(a) for a in (q, k, v)),
                         bias=jnp.asarray(bias), causal=False,
                         kv_mask=jnp.asarray(mask))
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v, bias)]
    o = flash_attention(*ts[:3], causal=False, bias=ts[3],
                        kv_mask=torch.tensor(mask))
    (o * torch.tensor(do)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(o[1].detach().numpy(),
                               np.broadcast_to(v[1].mean(0), (40, H, HD)),
                               rtol=0, atol=ATOL)
    assert not ts[0].grad[1].any() and not ts[1].grad[1].any()
    np.testing.assert_allclose(ts[2].grad[1].numpy(),
                               np.broadcast_to(do[1].sum(0) / 40,
                                               (40, H, HD)), atol=1e-6)


def test_bias_checks():
    q = torch.zeros(2, 8, H, HD)
    with pytest.raises(ValueError, match="batch-shared"):
        flash_attention(q, q, q, bias=torch.zeros(2, H, 8, 8))
    with pytest.raises(ValueError, match="bias must be"):
        flash_attention(q, q, q, bias=torch.zeros(H, 8, 9))
    with pytest.raises(ValueError, match="kv_mask must be"):
        flash_attention(q, q, q, kv_mask=torch.ones(2, 9, dtype=torch.bool))


SEEDS = [0, 1, -1, 12345, -987654321, 2 ** 31 - 1, -2 ** 31]


@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_is_jax_drop_keep_bit_for_bit(seed):
    """A grid of b*h, query and key positions whose products wrap int32."""
    bh = np.arange(0, 300, 7)
    q = np.asarray([0, 1, 63, 64, 1023, 4097, 65535, 2 ** 20 + 3,
                    2 ** 30 + 1, 2 ** 31 - 1])
    k = np.asarray([0, 2, 127, 128, 999, 2 ** 16, 2 ** 24 - 1, 2 ** 31 - 2])
    for rate in (0.1, 0.5):
        want = np.asarray(_drop_keep(
            jnp.int32(seed), jnp.asarray(bh, jnp.int32)[:, None, None],
            jnp.asarray(q, jnp.int32)[None, :, None],
            jnp.asarray(k, jnp.int32)[None, None, :], rate))
        got = drop_keep(seed, torch.tensor(bh)[:, None, None],
                        torch.tensor(q)[None, :, None],
                        torch.tensor(k)[None, None, :], rate).numpy()
        np.testing.assert_array_equal(got, want)


def test_keep_rate():
    pos = torch.arange(512)
    keep = drop_keep(7, torch.arange(4)[:, None, None], pos[:, None],
                     pos[None, :], 0.1)
    assert abs(float(keep.float().mean()) - 0.9) < 0.005


def _option_inputs(rng, T=24):
    q, k, v = (rng.standard_normal((2, T, 3, 8)).astype(np.float32)
               for _ in range(3))
    kv_mask = np.ones((2, T), bool)
    kv_mask[1, T // 2:] = False
    return q, k, v, dict(
        sink=rng.standard_normal(3).astype(np.float32),
        bias=rng.standard_normal((3, T, T)).astype(np.float32),
        kv_mask=kv_mask)


@pytest.mark.parametrize("opts", [("sink",), ("bias",), ("kv_mask",),
                                  ("kv_mask", "noncausal"),
                                  ("bias", "sink", "noncausal")])
def test_plain_options_match_jax_reference(opts):
    q, k, v, extra = _option_inputs(np.random.default_rng(5))
    kw = {o: extra[o] for o in opts if o != "noncausal"}
    causal = "noncausal" not in opts
    want = jax_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal,
                         **{n: jnp.asarray(a) for n, a in kw.items()})
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          causal=causal,
                          **{n: torch.tensor(a) for n, a in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_q_start_matches_jax_flash():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
               for _ in range(3))
    starts = np.zeros((1, 40), np.int32)
    starts[0, 15:] = 15
    starts[0, 31:] = 31
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     q_start=jnp.asarray(starts))
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          q_start=torch.tensor(starts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


def test_lse_is_the_row_logsumexp():
    q, k, v, _ = _inputs(50)
    o, lse = reference_flash_attention(
        *(torch.tensor(a) for a in (q, k, v)), window=9, return_lse=True)
    s = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(HD)
    pos = np.arange(50)
    keep = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < 9)
    s = np.where(keep, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) \
        + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)


def test_argument_checks():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, dropout=0.1)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, q, q, window=4, causal=False)
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, q[:, :4], q)


# ------------------------------------------------------------ the model

LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, max_len=64)


def _lm(**kw):
    torch.manual_seed(0)
    return TransformerLM(**LM, **kw, device="cpu")


def test_model_flash_path_matches_einsum_path():
    """drop 0: the flash dispatch and the einsum path give the same logits
    and gradients (the flash op runs its plain version on the CPU)."""
    x = torch.randint(0, 64, (2, 48), generator=torch.Generator()
                      .manual_seed(1))
    outs = []
    for flash in (True, False):
        m = _lm(drop=0.0, flash_attention=flash)
        logits, _ = m(x, train=True)
        logits.square().mean().backward()
        outs.append((logits.detach(), m.block_1.attn.qkv.weight.grad))
    torch.testing.assert_close(outs[0][0], outs[1][0], rtol=0, atol=1e-5)
    torch.testing.assert_close(outs[0][1], outs[1][1], rtol=0, atol=1e-5)


def test_model_dropout_only_in_training_calls():
    x = torch.randint(0, 64, (2, 48))
    m = _lm(drop=0.1, flash_attention=True)
    with torch.no_grad():
        eval_a, _ = m(x)
        eval_b, _ = m(x, train=False)
        torch.manual_seed(3)
        train_a, _ = m(x, train=True, generator=torch.Generator()
                       .manual_seed(9))
        torch.manual_seed(3)
        train_b, _ = m(x, train=True, generator=torch.Generator()
                       .manual_seed(9))
    assert torch.equal(eval_a, eval_b)
    assert torch.equal(train_a, train_b)       # same seeds, same masks
    assert not torch.allclose(train_a, eval_a)


def test_model_auto_flash_is_off_on_cpu_tensors():
    m = _lm(drop=0.0)
    assert m.flash_attention is None
    x = torch.randint(0, 64, (1, 16))
    m.flash_attention = False
    want, _ = m(x)
    m.flash_attention = None
    got, _ = m(x)
    assert torch.equal(got, want)


def test_model_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TransformerLM(**LM)
