"""The AWD-LSTM text classifier (applications/text.py) against the JAX
package on the CPU.

Small sizes: vocab 50, emb 8, hidden 12, 3 layers, texts of 3-40 tokens.
Weights are the JAX model's, carried by ``load_jax_params`` (BatchNorm
statistics included); all drops 0 and float32 compute, the port's
recurrence the float32 step loop that equals the JAX ``lax.scan``.
Tolerances: the loader's batches exactly; the decoder's logits and
attention atol 1e-5; the net's forward atol 1e-5 and each parameter's
gradient within 1e-3 of its largest entry; the frozen-then-unfrozen
Adam2 losses rtol 1e-4; evaluate rtol 1e-5 (AUC 1e-6); predict's
probabilities atol 1e-5, its labels exactly; weight copies exactly.
"""

import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import text as jtext
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.parallel import mesh as pmesh
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.applications import text
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.utils.jax_params import (
    _flatten,
    _torch_name,
    load_jax_params,
)

V, PAD, NCLS = 50, 1, 2
SIZE = dict(emb_dim=8, hidden_size=12, num_layers=3)
NO_DROPS = dict(enc_drops=(0.0, 0.0, 0.0, 0.0), fc_drops=(0.0, 0.0))
HEAD = dict(attn_size=6, fc_layer_sizes=(5,))
BUCKETS = (8, 16, 32)


# the attention scores' biases: a softmax over time does not see a shift
# common to every step, so dec.attn2.bias has gradient 0, and so has each
# entry of dec.attn1.bias whose unit stays active (or dead) at every step;
# what both packages compute there is float32 round-off
SHIFT_INVARIANT = ("dec.attn1.bias", "dec.attn2.bias")


def _np(tree):
    """numpy copies (the JAX Learner's step donates its buffers)."""
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _ds(n, seed):
    """Texts of 3-40 tokens (ids 4..V-1, no pad inside), labels 0/1 with
    the label's own tokens planted."""
    rng = np.random.default_rng(seed)
    texts, labels = [], []
    for _ in range(n):
        lab = int(rng.integers(0, NCLS))
        t = rng.integers(4, V, int(rng.integers(3, 41)))
        t[rng.random(len(t)) < 0.3] = 4 + lab
        texts.append(t.tolist())
        labels.append(lab)
    return _Texts(texts, labels)


class _Texts:
    """A numericalized dataset, as ``TextDataset`` leaves one."""

    stoi = {"_unk_": 0, "_pad_": PAD}

    def __init__(self, texts, labels):
        self.texts, self.labels = texts, labels

    def __len__(self):
        return len(self.texts)


def _data(mod, bs=4, bpg=2):
    return mod.TextClassificationDataObj(_ds(26, 0), _ds(10, 1), None, bs,
                                         bpg=bpg, seed=3)


def test_loader_batches_match_jax():
    """Two epochs of the shuffled loader and one of the sorted one, at
    buckets (8, 16, 32): the same group order, x, y, mask and n_valid."""
    ds = _ds(23, 5)
    for random in (True, False):
        jdl = jtext.TextClassificationDataLoader(ds, 4, PAD, 2, random, 7,
                                                 BUCKETS)
        pdl = text.TextClassificationDataLoader(ds, 4, PAD, 2, random, 7,
                                                BUCKETS)
        assert pdl.groups == jdl.groups and len(pdl) == len(jdl) == 6
        lens = set()
        for _ in range(2 if random else 1):
            for jb, pb in zip(jdl, pdl, strict=True):
                np.testing.assert_array_equal(pb.xs[0], jb.xs[0])
                np.testing.assert_array_equal(pb.y, jb.y)
                np.testing.assert_array_equal(pb.mask, jb.mask)
                assert pb.n_valid == jb.n_valid
                lens.add(pb.xs[0].shape[1])
        assert lens == set(BUCKETS)
    peek = pdl.peek()
    assert peek.xs[0].shape == (4, 32)
    assert (peek.xs[0] != PAD).sum(1).max() == 32   # longest texts first
    last = list(pdl)[-1]
    assert last.n_valid == 3 and last.mask.tolist() == [1, 1, 1, 0]


def test_dataobj_from_csv(tmp_path):
    import pandas as pd

    df = pd.DataFrame({"text": ["a good film", "a bad film", "good good",
                                "bad bad bad", "fine film"] * 4,
                       "label": ["pos", "neg", "pos", "neg", "pos"] * 4})
    df.to_csv(tmp_path / "t.csv", index=False)
    got = text.TextClassificationDataObj.from_csv(4, str(tmp_path / "t.csv"))
    want = jtext.TextClassificationDataObj.from_csv(4,
                                                    str(tmp_path / "t.csv"))
    assert got.target_type == want.target_type == "text_classify"
    assert got.stoi == want.stoi
    assert got.train_ds.texts == want.train_ds.texts
    assert got.val_ds.labels == want.val_ds.labels


def _decoder_pair(seed=0):
    jdec = jtext.TextClassificationDecoder(NCLS, 6, (5,), (0.0, 0.0), 8, PAD)
    rng = np.random.default_rng(seed)
    enc_out = rng.normal(0, 1, (4, 9, 8)).astype(np.float32)
    enc_in = rng.integers(4, V, (4, 9)).astype(np.int32)
    enc_in[1, 5:] = PAD
    enc_in[2, 1:] = PAD
    variables = jdec.init(jax.random.PRNGKey(seed), jnp.asarray(enc_in),
                          jnp.asarray(enc_out))
    pdec = text.TextClassificationDecoder(NCLS, 6, (5,), (0.0, 0.0), 8, PAD)
    load_jax_params(pdec, _np(variables["params"]),
                    batch_stats=_np(variables["batch_stats"]))
    return jdec, variables, pdec, enc_in, enc_out


@pytest.mark.parametrize("train", [False, True])
def test_decoder_logits_and_attention_match_jax(train):
    jdec, variables, pdec, enc_in, enc_out = _decoder_pair()
    if train:
        (jout, jattn), _ = jdec.apply(variables, enc_in, enc_out, train=True,
                                      return_attn=True,
                                      mutable=["batch_stats"])
    else:
        jout, jattn = jdec.apply(variables, enc_in, enc_out,
                                 return_attn=True)
    out, attn = pdec(torch.from_numpy(enc_in), torch.from_numpy(enc_out),
                     train=train, return_attn=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    np.testing.assert_allclose(attn.detach().numpy(), np.asarray(jattn),
                               atol=1e-5)
    a = attn.detach().numpy()
    assert (a[enc_in == PAD] == 0).all()
    np.testing.assert_allclose(a.sum(1), 1.0, rtol=1e-6)


def _net_pair(seed=0, T=32):
    jnet = jtext.TextClassificationNet(V, NCLS, PAD, **HEAD, **SIZE,
                                       **NO_DROPS)
    rng = np.random.default_rng(seed)
    x = rng.integers(4, V, (4, T)).astype(np.int32)
    x[0, 20:] = PAD
    x[3, 3:] = PAD
    variables = jnet.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    pnet = text.TextClassificationNet(V, NCLS, PAD, **HEAD, **SIZE,
                                      **NO_DROPS, lstm_kernel=False,
                                      device="cpu")
    load_jax_params(pnet, _np(variables["params"]),
                    batch_stats=_np(variables["batch_stats"]))
    return jnet, variables, pnet, x


@pytest.mark.parametrize("T", [5, 32])
def test_net_forward_and_gradients_match_jax(T):
    jnet, variables, pnet, x = _net_pair(T=T)
    y = np.array([0, 1, 1, 0], np.int32)

    def jloss(params):
        (logits, _), _ = jnet.apply({**variables, "params": params}, x,
                                    train=True, mutable=["batch_stats"])
        return jtext.SeqCrossEntropyLoss()(logits, jnp.asarray(y))

    jgrads = _np(jax.grad(jloss)(variables["params"]))
    jlogits, jenc, jattn = jnet.apply(variables, x, return_attn=True)
    logits, enc, attn = pnet(torch.from_numpy(x).long(), return_attn=True)
    for got, want in ((logits, jlogits), (enc, jenc), (attn, jattn)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)
    logits, _ = pnet(torch.from_numpy(x).long(), train=True)
    torch.nn.functional.cross_entropy(logits,
                                      torch.from_numpy(y).long()).backward()
    params = dict(pnet.named_parameters())
    top = max(np.abs(g).max() for _, g in _flatten(jgrads))
    for name, want in _flatten(jgrads):
        want = want.T if name.endswith(".kernel") else want
        name = _torch_name(name)
        got = params[name].grad.numpy()
        scale = top if name in SHIFT_INVARIANT else np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-3 * scale + 1e-12, err_msg=name)


def test_net_groups_kernel_switch_and_stateless_encoder():
    _, _, pnet, x = _net_pair()
    assert pnet.layer_group_prefixes == (
        ("enc/lstm_0", "enc/lstm_1", "enc/lstm_2"), ("enc/word_embed",),
        ("dec",))
    assert not list(pnet.buffers()) or all(
        "running" in n or "num_batches" in n
        for n, _ in pnet.named_buffers())
    xt = torch.from_numpy(x).long()
    first = pnet(xt)[0]
    pnet(torch.from_numpy(x[:2, :7]).long())      # another bucket between
    torch.testing.assert_close(pnet(xt)[0], first, rtol=0, atol=0)
    pnet.lstm_kernel = True       # lstm_scan's plain versions (bf16)
    assert all(layer.lstm_kernel for layer in pnet.enc.lstms())
    torch.testing.assert_close(pnet(xt)[0], first, rtol=0, atol=2e-2)


@pytest.fixture(scope="module")
def learners():
    jdata = _data(jtext)
    jm = jtext.TextClassificationNet(V, NCLS, PAD, **HEAD, **SIZE,
                                     **NO_DROPS)
    jl = JaxLearner(tempfile.mkdtemp(), jdata, jm, "Adam2",
                    mesh=get_mesh(1), seed=0)
    params, state = _np(jl.params), _np(jl.state)
    return jl, params, state


def _port_learner(learners):
    """The JAX Learner put back to its starting params and state (its
    train step donates their buffers), unfrozen, and a port Learner on
    the same weights."""
    jl, params, state = learners
    jl.params = pmesh.shard_params(params, jl.mesh, jl.param_sharding)
    jl.state = pmesh.replicate_tree(state, jl.mesh)
    jl.unfreeze()
    data = _data(text)
    pm = text.TextClassificationNet(V, NCLS, PAD, **HEAD, **SIZE, **NO_DROPS,
                                    lstm_kernel=False, device="cpu")
    load_jax_params(pm, params, batch_stats=state["batch_stats"])
    return Learner(tempfile.mkdtemp(), data, pm, "Adam2", seed=0,
                   device="cpu")


def test_frozen_then_unfrozen_trajectory_matches_jax(learners):
    """freeze(): three Adam2 steps train the head alone; unfreeze(): three
    more with per-group rates, on the shuffled loader's batches."""
    jl = learners[0]
    pl = _port_learner(learners)
    enc_before = {n: p.detach().clone()
                  for n, p in pl.model.enc.named_parameters()}
    got, want = [], []
    batches = zip(list(jl.data.train_dl), list(pl.data.train_dl))
    for stage, lr in (("freeze", 1e-3), ("unfreeze", [1e-3, 2e-3, 3e-3])):
        for learner in (jl, pl):
            getattr(learner, stage)()
            learner.init_optimizer(wd=1e-6, clip=0.4)
        for _ in range(3):
            jb, pb = next(batches)
            want.append(float(jl.train1minibatch(jb, lr)))
            got.append(float(pl.train1minibatch(pb, lr)))
        if stage == "freeze":
            for n, p in pl.model.enc.named_parameters():
                assert torch.equal(p, enc_before[n]), n
    np.testing.assert_allclose(got, want, rtol=1e-4)
    port = dict(pl.model.named_parameters())
    for name, arr in _flatten(_np(jl.params)):
        arr = arr.T if name.endswith(".kernel") else arr
        name = _torch_name(name)
        # Adam moves a parameter by about lr a step whatever the size of
        # its gradient, so where the gradient is round-off the packages
        # part by up to the rates' sum
        # part by up to the rates' sum.  So does the pad token's row: the
        # attention's renormalisation over the texts' own steps cancels
        # every path from a pad position to the logits
        got = port[name].detach().numpy()
        if name == "enc.word_embed.weight":
            np.testing.assert_allclose(got[PAD], arr[PAD], rtol=0,
                                       atol=9e-3)
            got, arr = np.delete(got, PAD, 0), np.delete(arr, PAD, 0)
        atol = 1e-4 if name not in SHIFT_INVARIANT else 9e-3
        np.testing.assert_allclose(got, arr, rtol=0, atol=atol,
                                   err_msg=name)


def test_evaluate_predict_and_accuracy_match_jax(learners):
    jl = learners[0]
    pl = _port_learner(learners)
    want = jl.evaluate("val", [jtext.TextClassificationAccuracy(), "auc"])
    got = pl.evaluate("val", [text.TextClassificationAccuracy(), "auc"])
    # 'text_classify' has no accuracy column, in either package
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    probs, labels = pl.predict("val")
    jprobs, jlabels = jl.predict("val")
    assert probs.shape == (10, NCLS)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, jlabels)
    acc = text.TextClassificationAccuracy()(
        torch.tensor([[0.0, 1.0], [2.0, 1.0], [0.0, 3.0]]),
        torch.tensor([1, 1, 1]), torch.tensor([1.0, 1.0, 0.0]))
    assert float(acc) == pytest.approx(0.5)


def _lm_pair():
    jlm = jtext.LanguageModelNet(vocab_size=V, pad_token=PAD, **SIZE)
    variables = jlm.init(jax.random.PRNGKey(4), jnp.zeros((2, 5), jnp.int32))
    plm = text.LanguageModelNet(vocab_size=V, pad_token=PAD, **SIZE,
                                device="cpu")
    load_jax_params(plm, _np(variables["params"]))
    return jlm, _np(variables["params"]), plm


def test_from_language_model_transfers_the_encoder():
    jlm, lm_params, plm = _lm_pair()
    jclf, transfer = jtext.TextClassificationNet.from_language_model(
        types.SimpleNamespace(model=jlm, params=lm_params), NCLS, **HEAD)
    x = jnp.asarray(np.full((2, 5), 7, np.int32))
    jparams = _np(transfer(jclf.init(jax.random.PRNGKey(0), x)["params"]))
    pclf, ptransfer = text.TextClassificationNet.from_language_model(
        types.SimpleNamespace(model=plm), NCLS, **HEAD)
    assert pclf.enc.lstm_0.weight_drop == pytest.approx(
        jclf.enc_drops[2] * jclf.drop_scaling)
    dec_before = {n: p.detach().clone()
                  for n, p in pclf.dec.named_parameters()}
    assert ptransfer(pclf) is pclf
    lm_enc = dict(plm.enc.named_parameters())
    for n, p in pclf.enc.named_parameters():
        assert torch.equal(p, lm_enc[n]), n
    for n, p in pclf.dec.named_parameters():
        assert torch.equal(p, dec_before[n]), n
    port = dict(pclf.named_parameters())
    for name, arr in _flatten(jparams["enc"]):
        np.testing.assert_array_equal(
            port["enc." + _torch_name(name)].detach().numpy(), arr)
    # the copy is a snapshot of the LM when from_language_model ran
    with torch.no_grad():
        plm.enc.lstm_0.w_ih.add_(1.0)
    ptransfer(pclf)
    assert not torch.equal(pclf.enc.lstm_0.w_ih, plm.enc.lstm_0.w_ih)


def test_load_torch_awd_lstm_matches_jax():
    """Random wt103-style state dicts (torch layout) into the LM, as the
    JAX converter puts them into its tree; tokens wt103 lacks get the mean
    row."""
    jlm, lm_params, plm = _lm_pair()
    rng = np.random.default_rng(9)
    E, H = SIZE["emb_dim"], SIZE["hidden_size"]
    sizes = [E, H, H, E]
    sd = {}
    for i in range(3):
        n_in, n_h = sizes[i], sizes[i + 1]
        for key, shape in (("weight_ih_l0", (4 * n_h, n_in)),
                           ("weight_hh_l0_raw", (4 * n_h, n_h)),
                           ("bias_ih_l0", (4 * n_h,)),
                           ("bias_hh_l0", (4 * n_h,))):
            sd[f"{i}.lstm.{key}"] = torch.from_numpy(
                rng.normal(0, 0.1, shape).astype(np.float32))
    emb = torch.from_numpy(rng.normal(0, 1, (70, E)).astype(np.float32))
    itos = {i: f"t{i}" for i in range(V)}
    stoi_wt103 = {f"t{i}": (3 * i) % 70 for i in range(0, V, 2)}
    want = _np(jtext.load_torch_awd_lstm(lm_params, sd, emb, itos,
                                         stoi_wt103))
    assert text.load_torch_awd_lstm(plm, sd, emb, itos, stoi_wt103) is plm
    port = dict(plm.named_parameters())
    for name, arr in _flatten(want):
        np.testing.assert_array_equal(
            port[_torch_name(name)].detach().numpy(), arr, err_msg=name)
    np.testing.assert_allclose(plm.enc.word_embed.weight[1].detach().numpy(),
                               emb.numpy().mean(0), rtol=1e-6)
