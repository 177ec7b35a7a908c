"""The AWD-LSTM language model through the port's Learner, against the JAX
Learner on the CPU.

Both start from the same weights and the same carry: the port's model is
filled from the JAX Learner's ``params`` and ``state["carry"]`` (the state
its ``init`` leaves) through ``load_jax_params``.  The loaders are the two
packages' own, fed the same texts with the same seed, so the batches are
identical (tests/test_torch_port_text.py).  All drops are 0 and compute is
float32, so the two trajectories differ only by float32 round-off: per-step
losses and the val loss are held to rtol 1e-5, parameters and the carried
state to atol 1e-5.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import text as jtext
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.applications import text
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.utils.jax_params import (
    _flatten,
    _torch_name,
    load_jax_params,
)

SIZE = dict(emb_dim=16, hidden_size=24, num_layers=3)
NO_DROPS = dict(enc_drops=(0.0, 0.0, 0.0, 0.0), dec_drop=0.0)
WORDS = [f"w{i}" for i in range(10)]


def _data(mod):
    """A periodic corpus: every text walks the 10 words in order from its
    own start."""
    texts = [" ".join(WORDS[(j + s) % 10] for j in range(40))
             for s in range(20)]
    ds = mod.TextDataset(texts, [0] * len(texts))
    return mod.LanguageModelDataObj(*ds.split_train_val(seed=0), None, 4, 8,
                                    seed=0)


@pytest.fixture(scope="module")
def trained():
    """Both learners after the same fit_one_cycle."""
    jdata = _data(jtext)
    jm = jtext.LanguageModelNet(vocab_size=len(jdata.stoi), pad_token=1,
                                **SIZE, **NO_DROPS)
    jl = JaxLearner(tempfile.mkdtemp(), jdata, jm, "Adam2",
                    loss_func=jtext.RegSeqCrossEntropyLoss(2.0, 1.0),
                    mesh=get_mesh(1), seed=0)
    data = _data(text)
    pm = text.LanguageModelNet(vocab_size=len(data.stoi), pad_token=1,
                               **SIZE, **NO_DROPS, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, jl.params)
    carry = jax.tree_util.tree_map(np.asarray, jl.state["carry"])
    load_jax_params(pm, tree, carry)
    pl = Learner(tempfile.mkdtemp(), data, pm, "Adam2",
                 loss_func=text.RegSeqCrossEntropyLoss(2.0, 1.0), seed=0,
                 device="cpu")
    jl.fit_one_cycle(1e-2, 2, wd=1e-6, clip=1.0)
    pl.fit_one_cycle(1e-2, 2, wd=1e-6, clip=1.0)
    return jl, pl


def test_fit_one_cycle_matches_jax(trained):
    jl, pl = trained
    want = np.asarray([float(x) for x in jl.loss_sched])
    got = np.asarray([float(x) for x in pl.loss_sched])
    assert len(got) == len(want) == 2 * len(pl.data.train_dl) > 20
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-5:].mean() < got[:5].mean()
    port = dict(pl.model.named_parameters())
    for name, arr in _flatten(jax.tree_util.tree_map(np.asarray,
                                                     jl.params)):
        np.testing.assert_allclose(port[_torch_name(name)].detach().numpy(),
                                   arr, rtol=0, atol=1e-5, err_msg=name)
    for name, arr in _flatten(jax.tree_util.tree_map(
            np.asarray, jl.state["carry"])):
        np.testing.assert_allclose(pl.model.get_buffer(name).numpy(), arr,
                                   rtol=0, atol=1e-5, err_msg=name)


def test_evaluate_with_accuracy_matches_jax(trained):
    """evaluate('val') goes on from the carried state in both packages."""
    jl, pl = trained
    got = pl.evaluate("val", [text.LanguageModelAccuracy()])
    want = jl.evaluate("val", [jtext.LanguageModelAccuracy()])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_predict_from_string_matches_jax(trained, monkeypatch):
    """Greedy (k 1) continuation, from a zero batch-1 carry in both: the
    JAX function starts from the state its model.init leaves, which is
    zeroed here for the comparison.  The port restores the Learner's
    carry afterwards."""
    jl, pl = trained
    init = jtext.LanguageModelNet.init

    def zero_carry_init(self, *args, **kwargs):
        variables = init(self, *args, **kwargs)
        return {**variables, "carry": jax.tree_util.tree_map(
            jnp.zeros_like, variables["carry"])}

    monkeypatch.setattr(jtext.LanguageModelNet, "init", zero_carry_init)
    before = [t.clone() for pair in pl.model.enc.carry() for t in pair]
    for prompt in ("w3 w4 w5", "w9"):
        want = jtext.predict_from_string(jl, prompt, 12, k=1)
        got = text.predict_from_string(pl, prompt, 12, k=1)
        assert got == want
        assert len(got.split()) == len(prompt.split()) + 12
    after = [t for pair in pl.model.enc.carry() for t in pair]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_save_load_keeps_the_carry(trained):
    _, pl = trained
    pl.save("lm")
    h1 = pl.model.enc.h1.clone()
    pl.model.reset_carry(1)
    pl.load("lm")
    assert torch.equal(pl.model.enc.h1, h1)
