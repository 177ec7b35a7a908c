"""Port of nn/seq2seq (the T5 slice) against the JAX package on the CPU:
``t5_relative_bucket`` exactly; ``EncoderBlock``, ``DecoderBlock`` and
``TransformerSeq2Seq`` outputs and gradients from the same weights
(``load_jax_params``) on a ragged padded source, in the BART, T5 and
Flan-T5 layouts, on the port's flash path and its einsum path; greedy
``seq2seq_generate`` tokens; the collate and the loss; and a short
``Learner`` trajectory on the reversal task of tests/test_seq2seq.py.

The JAX side runs its einsum attention (its flash kernels are held against
the port's op in tests/test_torch_port_flash_attention.py).  Tolerances,
float32 throughout: outputs atol 2e-5 on values of order 1 and gradients
atol 2e-5 relative to the largest entry of each (the two sum in different
orders; flax's LayerNorm takes its variance as mean(x^2) - mean(x)^2);
Learner losses rtol 1e-4 over 6 Adam steps.
"""

import functools
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.data import loader as jax_loader
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.nn import seq2seq as J
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.data import loader
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.nn import seq2seq as P
from neuralnetworklibrary_tpu_torch.utils.jax_params import (
    _flatten,
    _torch_name,
    load_jax_params,
)

V, PAD, BOS, EOS = 30, 0, 1, 2
ATOL = 2e-5
LAYOUTS = {
    "bart": dict(),
    "t5": dict(pos_embedding="relative", norm="rmsnorm", mlp_act="relu",
               logit_scale=32 ** -0.5),
    "flan": dict(pos_embedding="relative", norm="rmsnorm", mlp_act="gelu",
                 gated_mlp=True, tied_decoder=False),
}
BASE = dict(vocab_size=V, pad_token=PAD, d_model=32, n_heads=4,
            enc_layers=2, dec_layers=2, d_ff=48, max_src_len=48, max_len=24,
            drop=0.0)


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _close_grads(got: dict, want_tree, atol=ATOL):
    """Each port gradient within atol x its largest entry of JAX's."""
    for name, want in _flatten(_tree(want_tree)):
        if name.endswith(".kernel") and want.ndim == 2:
            want = want.T
        g = got[_torch_name(name)].grad.numpy()
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=atol * max(np.abs(want).max(), 1e-6),
                                   err_msg=name)


def _ragged(rng, B=2, S=20, T=9):
    src = rng.integers(3, V, (B, S))
    src[1, 13:] = PAD                       # a padded source row
    return src, rng.integers(3, V, (B, T))


# ------------------------------------------------------------ buckets


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("buckets,dist", [(32, 128), (16, 40)])
def test_relative_bucket_is_exact(bidirectional, buckets, dist):
    rel = np.arange(-600, 601)
    want = np.asarray(J.t5_relative_bucket(jnp.asarray(rel), bidirectional,
                                           buckets, dist))
    got = P.t5_relative_bucket(torch.tensor(rel), bidirectional, buckets,
                               dist)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ blocks


def _bias(rng, H, T, M):
    return (rng.standard_normal((1, H, T, M)) * 0.5).astype(np.float32)


ENC_KW = dict(norm="rmsnorm", mlp_act="relu")
DEC_KW = dict(norm="layernorm", mlp_act="gelu", gated_mlp=True)


@functools.cache
def _jax_encoder_block():
    """Inputs, params and JAX's output and gradients of sum(sin(block))."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 20, 32)).astype(np.float32)
    mask = np.arange(20)[None, :] < np.array([20, 13])[:, None]
    bias = _bias(rng, 4, 20, 20)
    jb = J.EncoderBlock(32, 4, 48, **ENC_KW)
    params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     jnp.asarray(mask))["params"]

    def jloss(p, xx):
        out = jb.apply({"params": p}, xx, jnp.asarray(mask),
                       att_bias=jnp.asarray(bias))
        return jnp.sum(jnp.sin(out)), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (x, mask, bias), _tree(params), np.asarray(out), gp, gx


@functools.cache
def _jax_decoder_block():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 32)).astype(np.float32)
    mk, mv = (rng.standard_normal((2, 20, 4, 8)).astype(np.float32)
              for _ in range(2))
    mem = np.arange(20)[None, :] < np.array([20, 13])[:, None]
    bias = _bias(rng, 4, 9, 9)
    jb = J.DecoderBlock(32, 4, 48, max_len=24, **DEC_KW)
    args = [jnp.asarray(a) for a in (x, mk, mv, mem)]
    params = jb.init(jax.random.PRNGKey(0), *args)["params"]

    def jloss(p, xx):
        out = jb.apply({"params": p}, xx, *args[1:],
                       att_bias=jnp.asarray(bias))
        return jnp.sum(jnp.sin(out)), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(params, args[0])
    tree = _tree(params)
    # the block is called on precomputed memory K/V, so flax never made
    # the cross-attention's kv projection; the port's module has one
    tree["cross"]["kv"] = {"kernel": rng.standard_normal((32, 64))
                           .astype(np.float32),
                           "bias": np.zeros(64, np.float32)}
    return (x, mk, mv, mem, bias), tree, np.asarray(out), gp, gx


def _check_block(port, out, want, gp, gx, xt):
    torch.sin(out).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=0,
                               atol=ATOL)
    _close_grads(dict(port.named_parameters()), gp)


@pytest.mark.parametrize("flash", [True, False])
def test_encoder_block_matches_jax(flash):
    """Bidirectional self-attention with the key mask and a bias, on the
    port's flash path (its plain version here) and einsum path."""
    (x, mask, bias), tree, want, gp, gx = _jax_encoder_block()
    pb = load_jax_params(P.EncoderBlock(32, 4, 48, **ENC_KW, device="cpu"),
                         tree)
    xt = torch.tensor(x, requires_grad=True)
    out = pb(xt, torch.tensor(mask), att_bias=torch.tensor(bias),
             flash=flash)
    _check_block(pb, out, want, gp, gx, xt)


@pytest.mark.parametrize("flash", [True, False])
def test_decoder_block_matches_jax(flash):
    """Causal self-attention with a bias, cross-attention into a ragged
    memory, GEGLU MLP."""
    (x, mk, mv, mem, bias), tree, want, gp, gx = _jax_decoder_block()
    pb = load_jax_params(P.DecoderBlock(32, 4, 48, **DEC_KW, device="cpu"),
                         tree)
    xt = torch.tensor(x, requires_grad=True)
    out = pb(xt, torch.tensor(mk), torch.tensor(mv), torch.tensor(mem),
             att_bias=torch.tensor(bias), flash=flash)
    _check_block(pb, out, want, gp, gx, xt)


# ------------------------------------------------------------ the model


def _pair(layout, seed=0):
    """(JAX model, its params, port model on cpu with the same weights)."""
    cfg = dict(BASE, **LAYOUTS[layout])
    jm = J.TransformerSeq2Seq(**cfg)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32),
                     jnp.zeros((1, 4), jnp.int32))["params"]
    pm = load_jax_params(P.TransformerSeq2Seq(**cfg, device="cpu"),
                         _tree(params))
    return jm, params, pm


@functools.cache
def _jax_model_run(layout):
    """Inputs, params and JAX's logits and gradients of mean(logits^2)."""
    jm, params, _ = _pair(layout)
    src, tgt = _ragged(np.random.default_rng(3))

    def jloss(p):
        logits, _ = jm.apply({"params": p}, jnp.asarray(src, jnp.int32),
                             jnp.asarray(tgt, jnp.int32))
        return jnp.mean(jnp.square(logits)), logits

    (_, want), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params)
    return src, tgt, _tree(params), np.asarray(want), grads


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_model_logits_and_grads_match_jax(layout, flash):
    src, tgt, tree, want, grads = _jax_model_run(layout)
    pm = load_jax_params(P.TransformerSeq2Seq(
        **BASE, **LAYOUTS[layout], flash_attention=flash, device="cpu"),
        tree)
    logits, _ = pm(torch.tensor(src), torch.tensor(tgt))
    logits.square().mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=0,
                               atol=ATOL)
    _close_grads(dict(pm.named_parameters()), grads)


def test_load_jax_params_lands_every_t5_leaf():
    """The untied Flan-T5 tree: Dense kernels transposed; the (buckets, H)
    tables and the (V, D) lm_head are plain leaves, kept as they are."""
    _, params, pm = _pair("flan")
    port = dict(pm.named_parameters())
    names = set()
    for name, arr in _flatten(_tree(params)):
        tn = _torch_name(name)
        names.add(tn)
        want = arr.T if name.endswith(".kernel") and arr.ndim == 2 else arr
        np.testing.assert_array_equal(port[tn].detach().numpy(), want,
                                      err_msg=name)
    assert names == set(port)
    assert port["enc_rel_bias"].shape == (32, 4)
    assert port["lm_head"].shape == (V, 32)
    assert "dec_block_1.cross.kv.weight" in port


@pytest.mark.parametrize("layout", ["bart", "t5"])
def test_generate_greedy_matches_jax(layout):
    """One encoder pass, cached decode steps: the same greedy tokens, and
    they are the argmax of the teacher-forced forward."""
    jm, params, pm = _pair(layout, seed=4)
    with torch.no_grad():
        pm.word_embed.mul_(50.0)           # logits far from ties
    params = dict(params, word_embed=params["word_embed"] * 50.0)
    src, _ = _ragged(np.random.default_rng(5), S=11)
    want = np.asarray(J.seq2seq_generate(jm, params, src, 8, bos=BOS))
    got = P.seq2seq_generate(pm, src, 8, bos=BOS)
    np.testing.assert_array_equal(got.numpy(), want)
    tin = torch.cat([torch.full((2, 1), BOS), got[:, :-1]], 1)
    with torch.no_grad():
        logits, _ = pm(torch.tensor(src), tin)
    assert torch.equal(logits.argmax(-1), got)


def test_generate_top_k_draws_from_the_top_k():
    _, _, pm = _pair("t5")
    src, _ = _ragged(np.random.default_rng(6))
    a = P.seq2seq_generate(pm, src, 6, BOS, k=3,
                           generator=torch.Generator().manual_seed(0))
    b = P.seq2seq_generate(pm, src, 6, BOS, k=3,
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.shape == (2, 6)
    assert ((a >= 0) & (a < V)).all()


def test_collate_and_loss_match_jax():
    rng = np.random.default_rng(7)
    pairs = [(rng.integers(3, V, n).tolist(), rng.integers(3, V, m).tolist())
             for n, m in ((5, 3), (2, 6), (7, 1))]
    for kw in ({}, {"max_src": 6, "max_tgt": 4}):
        for a, b in zip(P.seq2seq_collate(pairs, PAD, BOS, EOS, **kw),
                        J.seq2seq_collate(pairs, PAD, BOS, EOS, **kw)):
            np.testing.assert_array_equal(a, b)
    logits = rng.standard_normal((3, 7, V)).astype(np.float32)
    tout = J.seq2seq_collate(pairs, PAD, BOS, EOS)[2]
    mask = np.array([1.0, 1.0, 0.0], np.float32)
    for m in (None, mask):
        want = J.Seq2SeqCrossEntropyLoss(PAD)(
            (jnp.asarray(logits), None), jnp.asarray(tout),
            None if m is None else jnp.asarray(m))
        got = P.Seq2SeqCrossEntropyLoss(PAD)(
            (torch.tensor(logits), None), torch.tensor(tout).long(),
            None if m is None else torch.tensor(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_layer_groups_and_unported_options():
    _, _, pm = _pair("flan")
    enc, dec, head = pm.layer_group_prefixes
    assert "enc_rel_bias" in enc and "dec_rel_bias" in dec
    assert head == ("word_embed", "lm_head")
    for kw in ({"kv_quant": True}, {"audio_frontend": True}):
        with pytest.raises(NotImplementedError):
            P.TransformerSeq2Seq(**BASE, **kw, device="cpu")


# ------------------------------------------------------------ the slice


def _reversal_data(ds_mod, dl_mod, n=24, bs=8, L=6):
    rng = np.random.default_rng(0)
    srcs = rng.integers(3, V, (n, L))
    lengths = rng.integers(3, L + 1, n)        # ragged, padded sources
    pairs = [(s[:m].tolist(), s[:m].tolist()[::-1])
             for s, m in zip(srcs, lengths)]
    ds = ds_mod(*J.seq2seq_collate(pairs, PAD, BOS, EOS, max_src=L,
                                   max_tgt=L))
    return types.SimpleNamespace(
        target_type="seq2seq", bs=bs,
        train_dl=dl_mod(ds, bs, shuffle=True, prefetch=0),
        val_dl=dl_mod(ds, bs, prefetch=0), train_ds=ds, val_ds=ds)


def test_learner_matches_jax_on_reversal():
    """fit_one_cycle of a T5-layout model, JAX Learner against the port's
    (flash path: its plain version here), same weights, same batches."""
    cfg = dict(BASE, **LAYOUTS["t5"])
    jl = JaxLearner(tempfile.mkdtemp(),
                    _reversal_data(jax_loader.ArrayDataset,
                                   jax_loader.DataLoader),
                    J.TransformerSeq2Seq(**cfg), "Adam2",
                    loss_func=J.Seq2SeqCrossEntropyLoss(PAD),
                    mesh=get_mesh(1), seed=0)
    pm = load_jax_params(P.TransformerSeq2Seq(**cfg, flash_attention=True,
                                              device="cpu"),
                         _tree(jl.params))
    pl = Learner(tempfile.mkdtemp(),
                 _reversal_data(loader.ArrayDataset, loader.DataLoader), pm,
                 "Adam2", loss_func=P.Seq2SeqCrossEntropyLoss(PAD), seed=0,
                 device="cpu")
    jl.fit_one_cycle(3e-3, 2, wd=1e-4)
    pl.fit_one_cycle(3e-3, 2, wd=1e-4)
    want = np.asarray([float(x) for x in jl.loss_sched])
    got = np.asarray([float(x) for x in pl.loss_sched])
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    np.testing.assert_allclose(pl.evaluate("val")[0], jl.evaluate("val")[0],
                               rtol=1e-4)
