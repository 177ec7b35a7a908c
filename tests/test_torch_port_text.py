"""Port of applications/text.py's language-model path against the JAX
package on the CPU: tokenizer, LM data, the AWD-LSTM modules, the losses
and the parameter bridge.

Tolerances: the tokenizer, the vocab, the loader's batches and the layer
groups are exact (the same Python code or rule).  The models run the
float32 step loop (``lstm_kernel=False``, what JAX runs on the CPU) from
the same weights and carry; outputs, gradients and the loss are held to
atol 1e-5 (values of order 1; only the order of float32 sums differs).
Dropout masks come from different generators in the two packages, so
dropout is checked for its shapes and scaling only.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import text as jtext
from neuralnetworklibrary_tpu.core.partition import (
    build_partition as jax_partition,
)
from neuralnetworklibrary_tpu.data.split import SplitTrainVal as JaxSplit
from neuralnetworklibrary_tpu_torch.applications import text
from neuralnetworklibrary_tpu_torch.core.partition import build_partition
from neuralnetworklibrary_tpu_torch.data.split import SplitTrainVal
from neuralnetworklibrary_tpu_torch.utils.jax_params import (
    _torch_name,
    load_jax_params,
)

V, E, H, L = 64, 16, 24, 3
LM = dict(vocab_size=V, pad_token=1, emb_dim=E, hidden_size=H,
          num_layers=L)
TOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_lm(seed=0, B=3, T=7):
    jm = jtext.LanguageModelNet(**LM)
    x = jnp.zeros((B, T), jnp.int32)
    variables = jm.init({"params": jax.random.PRNGKey(seed),
                         "dropout": jax.random.PRNGKey(seed)}, x)
    return jm, variables["params"], variables["carry"]


def _port_lm(params, carry=None, **kw):
    pm = text.LanguageModelNet(**LM, lstm_kernel=False, device="cpu", **kw)
    return load_jax_params(pm, _np_tree(params),
                           None if carry is None else _np_tree(carry))


def _zeros_like(tree):
    return jax.tree_util.tree_map(jnp.zeros_like, tree)


# ------------------------------------------------------------ tokenizer


def _golden():
    path = os.path.join(os.path.dirname(__file__), "fixtures",
                        "tokenizer_golden.json")
    with open(path) as f:
        return json.load(f)["cases"]


def test_tokenizer_matches_golden_and_jax():
    cases = _golden()
    texts = [c["text"] for c in cases]
    got = text.tokenize(texts)
    assert got == jtext.tokenize(texts)
    for c, toks in zip(cases, got):
        assert toks == c.get("ours", c["tokens"]), c["text"]


@pytest.mark.parametrize("min_freq", [1, 2])
def test_numericalize_matches_jax(min_freq):
    toks = text.tokenize([c["text"] for c in _golden()] * 2)
    got, stoi = text.numericalize(toks, min_freq=min_freq)
    want, jstoi = jtext.numericalize(toks, min_freq=min_freq)
    assert stoi == jstoi
    assert got == want
    again, same = text.numericalize([["the", "zzz-unseen"]], stoi=stoi)
    assert same is stoi and again[0][1] == 0


@pytest.mark.parametrize("n", [2, 64])
def test_tokenize_mp_matches_tokenize(n):
    """Below 64 texts in-process; from 64 on two spawned workers."""
    texts = [c["text"] for c in _golden()][:n]
    texts += ["Hello WORLD, it's 10:30."] * (n - len(texts))
    assert text.tokenize_mp(texts, ncpus=2) == text.tokenize(texts)


# ------------------------------------------------------------ data


def _texts(n=40, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(12)]
    return [" ".join(words[j] for j in rng.integers(0, 12, rng.integers(
        20, 60))) for _ in range(n)]


def test_split_train_val_matches_jax():
    import pandas as pd

    items = list(range(23))
    assert SplitTrainVal(items, val_frac=0.3, seed=4) == JaxSplit(
        items, val_frac=0.3, seed=4)
    df = pd.DataFrame({"a": np.arange(10)})
    got, want = SplitTrainVal(df, seed=1), JaxSplit(df, seed=1)
    for g, w in zip(got, want):
        assert g.equals(w)


def test_text_dataset_and_split_match_jax():
    texts, labels = _texts(), [0] * 40
    ds, jds = text.TextDataset(texts, labels), jtext.TextDataset(texts,
                                                                labels)
    assert ds.stoi == jds.stoi and ds.texts == jds.texts
    assert ds.num_tokens == jds.num_tokens
    (tr, va), (jtr, jva) = ds.split_train_val(seed=3), jds.split_train_val(
        seed=3)
    assert tr.texts == jtr.texts and va.texts == jva.texts
    assert va.num_tokens == jva.num_tokens


def test_lm_loader_batches_match_jax_for_two_epochs():
    texts = _texts(60, seed=1)
    ds = text.TextDataset(texts, [0] * len(texts))
    jds = jtext.TextDataset(texts, [0] * len(texts))
    a = text.LanguageModelDataObj(*ds.split_train_val(seed=2), None, 4, 9,
                                  seed=5)
    b = jtext.LanguageModelDataObj(*jds.split_train_val(seed=2), None, 4, 9,
                                   seed=5)
    assert a.target_type == b.target_type == "lang_model"
    for dl, jdl in ((a.train_dl, b.train_dl), (a.val_dl, b.val_dl)):
        assert len(dl) == len(jdl) > 1
        for _ in range(2):
            got, want = list(dl), list(jdl)
            assert len(got) == len(want) == len(dl)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.xs[0], w.xs[0])
                np.testing.assert_array_equal(g.y, w.y)
                np.testing.assert_array_equal(g.mask, w.mask)
                assert g.n_valid == w.n_valid
        np.testing.assert_array_equal(dl.peek().xs[0], jdl.peek().xs[0])
    assert a.train_dl.epoch == 2


def test_lm_dataobj_from_csv_matches_jax(tmp_path):
    import pandas as pd

    path = str(tmp_path / "lm.csv")
    pd.DataFrame({"text": _texts(50, seed=3)}).to_csv(path, index=False)
    a = text.LanguageModelDataObj.from_csv(4, 8, path)
    b = jtext.LanguageModelDataObj.from_csv(4, 8, path)
    assert a.stoi == b.stoi
    np.testing.assert_array_equal(next(iter(a.train_dl)).xs[0],
                                  next(iter(b.train_dl)).xs[0])


# ------------------------------------------------------------ modules


def test_weight_drop_lstm_matches_jax():
    """WeightDropLSTM eval forward and every gradient, f32 loop path, from
    a nonzero (h0, c0)."""
    B, T, I = 3, 6, 10
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, T, I)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (B, H)).astype(np.float32)
    c0 = rng.normal(0, 0.3, (B, H)).astype(np.float32)
    jm = jtext.WeightDropLSTM(H, 0.5)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(h0),
                     jnp.asarray(c0))["params"]

    def jloss(p, x, h0, c0):
        ys, hT, cT = jm.apply({"params": p}, x, h0, c0, train=False)
        return jnp.sum(ys * jnp.cos(ys)) + jnp.sum(hT) + jnp.sum(cT ** 2), ys

    (_, ys_want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                             has_aux=True)(
        params, *map(jnp.asarray, (x, h0, c0)))
    pm = text.WeightDropLSTM(I, H, 0.5, lstm_kernel=False, device="cpu")
    load_jax_params(pm, _np_tree(params))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, h0, c0)]
    ys, hT, cT = pm(*ts, train=False)
    ((ys * torch.cos(ys)).sum() + hT.sum() + cT.square().sum()).backward()
    np.testing.assert_allclose(ys.detach().numpy(), ys_want, rtol=0,
                               atol=TOL)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[0][name], rtol=0,
                                   atol=TOL, err_msg=name)
    for t, g, name in zip(ts, grads[1:], ("x", "h0", "c0")):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=TOL,
                                   err_msg=name)


def test_weight_drop_lstm_scan_path_on_cpu_is_close_to_the_loop():
    """lstm_kernel=True reaches ops.lstm_scan (its plain versions on the
    CPU): bf16 weights and residuals, so within bf16 error of the loop."""
    rng = np.random.default_rng(2)
    pm = text.WeightDropLSTM(10, H, lstm_kernel=True, device="cpu")
    x = torch.from_numpy(rng.normal(0, 1, (2, 5, 10)).astype(np.float32))
    z = torch.zeros(2, H)
    ys_scan = pm(x, z, z)[0]
    pm.lstm_kernel = False
    ys_loop = pm(x, z, z)[0]
    assert torch.equal(ys_scan, ys_scan.to(torch.bfloat16).float())
    assert float((ys_scan - ys_loop).abs().max().detach()) < 2e-2


@pytest.mark.parametrize("carry", ["zeroed", "bridged"])
def test_lm_forward_and_gradients_match_jax(carry):
    """LanguageModelNet eval forward: logits, enc_out, the new carry, and
    the gradient of RegSeqCrossEntropyLoss for every parameter.  'bridged'
    hands the post-window carry of flax init() to the port."""
    jm, params, jcarry = _jax_lm()
    if carry == "zeroed":
        jcarry = _zeros_like(jcarry)
    rng = np.random.default_rng(3)
    x = rng.integers(0, V, (3, 7)).astype(np.int32)
    y = rng.integers(0, V, (3, 7)).astype(np.int32)
    jloss_fn = jtext.RegSeqCrossEntropyLoss(2.0, 1.0)

    def jloss(p):
        out, mut = jm.apply({"params": p, "carry": jcarry}, jnp.asarray(x),
                            train=False, mutable=["carry"])
        return jloss_fn(out, jnp.asarray(y)), (out, mut["carry"])

    (lv, (out, new_carry)), grads = jax.value_and_grad(jloss, has_aux=True)(
        params)
    pm = _port_lm(params, jcarry)
    got = pm(torch.from_numpy(x).long())
    loss = text.RegSeqCrossEntropyLoss(2.0, 1.0)(got, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(lv), rtol=0,
                               atol=TOL)
    for g, w, name in zip(got, out, ("logits", "enc_out")):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=TOL,
                                   err_msg=name)
    for i in range(L):
        for n in ("h", "c"):
            np.testing.assert_allclose(
                getattr(pm.enc, f"{n}{i}").numpy(),
                new_carry["enc"][f"{n}{i}"], rtol=0, atol=TOL)
    flat = dict(pm.named_parameters())
    for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
        name = _torch_name(".".join(k.key for k in path))
        np.testing.assert_allclose(flat[name].grad.numpy(), g, rtol=0,
                                   atol=TOL, err_msg=name)


def test_carry_continues_over_two_windows_like_jax():
    """Two consecutive eval windows: the port's buffers carry (h, c) from
    the first into the second as the JAX carry collection does; and two
    windows equal one window of both."""
    jm, params, jcarry = _jax_lm(seed=2)
    jcarry = _zeros_like(jcarry)
    x = np.random.default_rng(4).integers(0, V, (3, 12)).astype(np.int32)
    pm = _port_lm(params, jcarry)
    for sl in (slice(0, 5), slice(5, 12)):
        (want, _), mut = jm.apply({"params": params, "carry": jcarry},
                                  jnp.asarray(x[:, sl]), mutable=["carry"])
        jcarry = mut["carry"]
        got, _ = pm(torch.from_numpy(x[:, sl]).long())
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=TOL)
    pm.reset_carry()
    assert all(not h.any() and not c.any() for h, c in pm.enc.carry())
    whole, _ = pm(torch.from_numpy(x).long())
    np.testing.assert_allclose(whole[:, 5:].detach().numpy(), want, rtol=0,
                               atol=TOL)


def test_carry_rezeroes_on_a_new_batch_size_and_survives_save_load():
    _, params, jcarry = _jax_lm(seed=3)
    pm = _port_lm(params, jcarry)
    assert pm.enc.h0.shape == (3, H)
    state = {k: v.clone() for k, v in pm.state_dict().items()}
    pm(torch.zeros(2, 4, dtype=torch.long))
    assert pm.enc.h0.shape == (2, H) and pm.enc.h2.shape == (2, E)
    pm.load_state_dict(state)
    assert torch.equal(pm.enc.c1, state["enc.c1"])
    assert not torch.equal(pm.enc.h1, pm.enc.c1)


def test_layer_groups_match_jax():
    jm, params, _ = _jax_lm()
    jpart = jax_partition(params, None, jm.layer_group_prefixes,
                          jm.head_prefixes)
    pm = _port_lm(params)
    part = build_partition(pm, pm.layer_group_prefixes, pm.head_prefixes)
    want = {_torch_name(".".join(p)): (g, h) for p, g, h in
            zip(jpart.paths, jpart.group_idx, jpart.in_head)}
    got = {".".join(p): (g, h) for p, g, h in
           zip(part.paths, part.group_idx, part.in_head)}
    assert got == want and part.n_groups == 2


def test_from_dataobj_and_fused_ce():
    data = text.LanguageModelDataObj(
        *text.TextDataset(_texts(), [0] * 40).split_train_val(), None, 4, 8)
    pm = text.LanguageModelNet.from_dataobj(data, emb_dim=E, hidden_size=H,
                                            device="cpu")
    assert pm.vocab_size == len(data.stoi) and pm.pad_token == 1
    assert not pm.enc.word_embed.weight[1].any()
    assert pm.lstm_kernel is None
    pm.lstm_kernel = False
    assert all(layer.lstm_kernel is False for layer in pm.enc.lstms())
    # fused_ce: the decoder's input, the tied weight and the encoder
    # output, for FusedRegSeqCrossEntropyLoss (the chunked CE)
    fm = text.LanguageModelNet(V, emb_dim=E, hidden_size=H, fused_ce=True,
                               device="cpu")
    h, tied, enc_out = fm(torch.zeros(2, 5, dtype=torch.long))
    assert h.shape == enc_out.shape == (2, 5, E)
    assert tied is fm.enc.word_embed.weight


# ------------------------------------------------------------ dropout


def test_locked_dropout_shapes_and_scaling():
    x = torch.ones(64, 9, 32)
    gen = torch.Generator().manual_seed(0)
    out = text.locked_dropout(x, 0.25, True, gen)
    assert set(out.unique().tolist()) <= {0.0, float(np.float32(1 / 0.75))}
    assert torch.equal(out, out[:, :1].expand_as(out))   # shared over time
    assert abs(float(out.mean()) - 1.0) < 0.05
    assert text.locked_dropout(x, 0.25, False, gen) is x


def test_model_dropout_acts_only_in_training():
    _, params, _ = _jax_lm()
    pm = _port_lm(params, enc_drops=(0.3, 0.3, 0.3, 0.3), dec_drop=0.3)
    x = torch.from_numpy(np.random.default_rng(5).integers(0, V, (3, 6)))

    def run(train, seed):
        pm.reset_carry()
        return pm(x, train=train,
                  generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(False, 0), run(False, 1))
    assert torch.equal(run(True, 0), run(True, 0))
    assert not torch.equal(run(True, 0), run(True, 1))
    assert not torch.equal(run(True, 0), run(False, 0))


def test_embedding_dropout_drops_whole_rows():
    emb = text.EmbeddingDropout(50, 8, 0.5, 0.0, 1, device="cpu")
    x = torch.arange(50)[None]
    out, raw = emb(x, True, torch.Generator().manual_seed(0))
    assert raw is emb.weight
    dropped = (out[0] == 0).all(-1)
    kept = ~dropped
    assert 5 < int(dropped.sum()) < 45
    torch.testing.assert_close(out[0][kept], emb.weight[kept] * 2.0)


def test_weight_drop_applies_in_training_only():
    pm = text.WeightDropLSTM(4, 8, 0.5, lstm_kernel=False, device="cpu")
    x = torch.randn(2, 3, 4)
    z = torch.zeros(2, 8)
    gen = torch.Generator().manual_seed(0)
    base = pm(x, z, z)[0]
    assert torch.equal(pm(x, z, z, train=False, generator=gen)[0], base)
    # the first step does not see w_hh (h0 = 0); later steps do
    dropped = pm(x, z, z, train=True, generator=gen)[0]
    assert torch.equal(dropped[:, 0], base[:, 0])
    assert not torch.equal(dropped[:, 1:], base[:, 1:])


# ------------------------------------------------------------ losses


@pytest.mark.parametrize("masked", [False, True])
def test_reg_loss_value_and_gradients_match_jax(masked):
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 1, (3, 5, V)).astype(np.float32)
    enc = rng.normal(0, 1, (3, 5, E)).astype(np.float32)
    y = rng.integers(0, V, (3, 5)).astype(np.int32)
    mask = np.asarray([1, 0, 1], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    jf = jtext.RegSeqCrossEntropyLoss(2.0, 1.0)
    want, (gl, ge) = jax.value_and_grad(
        lambda a, b: jf((a, b), jnp.asarray(y), jm), argnums=(0, 1))(
        jnp.asarray(logits), jnp.asarray(enc))
    tl, te = (torch.tensor(a, requires_grad=True) for a in (logits, enc))
    got = text.RegSeqCrossEntropyLoss(2.0, 1.0)(
        (tl, te), torch.from_numpy(y),
        None if mask is None else torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(tl.grad.numpy(), gl, rtol=0, atol=1e-7)
    np.testing.assert_allclose(te.grad.numpy(), ge, rtol=0, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_seq_ce_and_accuracy_match_jax(masked):
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 1, (4, 6, V)).astype(np.float32)
    logits[0, :, 2] = 9.0          # a special token wins before masking
    y = rng.integers(0, V, (4, 6)).astype(np.int32)
    y[1] = logits[1].argmax(-1)
    mask = np.asarray([1, 1, 0, 1], np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    out = (torch.from_numpy(logits), None)
    jout = (jnp.asarray(logits), None)
    np.testing.assert_allclose(
        float(text.SeqCrossEntropyLoss()(out, torch.from_numpy(y), tm)),
        float(jtext.SeqCrossEntropyLoss()(jout, jnp.asarray(y), jm)),
        rtol=0, atol=TOL)
    np.testing.assert_allclose(
        float(text.LanguageModelAccuracy()(out, torch.from_numpy(y), tm)),
        float(jtext.LanguageModelAccuracy()(jout, jnp.asarray(y), jm)),
        rtol=0, atol=1e-7)


# ------------------------------------------------------------ bridge


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_rejects_a_bad_params_tree(fault):
    _, params, _ = _jax_lm()
    tree = _np_tree(params)
    lstm = tree["enc"]["lstm_1"]
    if fault == "missing":
        del lstm["b_hh"]
    elif fault == "extra":
        lstm["w_xx"] = np.zeros(3, np.float32)
    else:
        lstm["w_ih"] = lstm["w_ih"][:, :-4]
    match = {"missing": r"missing \['enc.lstm_1.b_hh'\]",
             "extra": r"extra \['enc.lstm_1.w_xx'\]",
             "shape": "enc.lstm_1.w_ih"}[fault]
    with pytest.raises(ValueError, match=match):
        load_jax_params(text.LanguageModelNet(**LM, device="cpu"), tree)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_bridge_rejects_a_bad_carry(fault):
    _, params, carry = _jax_lm()
    carry = _np_tree(carry)
    enc = carry["enc"]
    if fault == "missing":
        del enc["c2"]
    elif fault == "extra":
        enc["h3"] = enc["h2"]
    else:
        enc["h1"] = enc["h1"][:, :-1]
    match = {"missing": r"missing \['enc.c2'\]", "extra": r"extra "
             r"\['enc.h3'\]", "shape": "enc.h1"}[fault]
    with pytest.raises(ValueError, match=match):
        load_jax_params(text.LanguageModelNet(**LM, device="cpu"),
                        _np_tree(params), carry)


def test_bridge_copies_lstm_leaves_without_transposing():
    _, params, carry = _jax_lm()
    pm = _port_lm(params, carry)
    tree, carry = _np_tree(params), _np_tree(carry)
    np.testing.assert_array_equal(pm.enc.lstm_0.w_ih.detach().numpy(),
                                  tree["enc"]["lstm_0"]["w_ih"])
    np.testing.assert_array_equal(pm.enc.word_embed.weight.detach().numpy(),
                                  tree["enc"]["word_embed"]["weight"])
    np.testing.assert_array_equal(pm.enc.c2.numpy(), carry["enc"]["c2"])
