"""Structured data (applications/structured.py) and the embedding layers
(nn/layers.py) against the JAX package on the CPU.

A small Rossmann-like frame (dates, a store column, a 0/1 promo event,
categorical columns with NaN and unseen levels, continuous columns with
NaN).  Weights are the JAX model's, carried by ``load_jax_params``
(BatchNorm statistics included); drops 0, float32.  Tolerances: the
pandas helpers exactly (``assert_frame_equal``); forwards within 1e-5
of the largest output (or 1e-5);
BatchNorm running statistics after a train forward atol 1e-6; the
``max_norm`` gradient atol 1e-6; ``evaluate`` rtol 1e-5, its accuracy
exactly.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from neuralnetworklibrary_tpu.applications import structured as jst
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.nn import layers as jlayers
from neuralnetworklibrary_tpu.parallel import mesh as pmesh
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.applications import structured as st
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.nn import layers
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


def _frame(n=120, seed=0):
    rng = np.random.default_rng(seed)
    df = pd.DataFrame({
        "Date": pd.date_range("2015-01-01", periods=n // 3, freq="D")
        .repeat(3).strftime("%Y-%m-%d"),
        "Store": np.tile([1, 2, 3], n // 3),
        "Promo": (rng.random(n) < 0.3).astype(int),
        "StoreType": rng.choice(["a", "b", "c", "d"], n),
        "Assortment": rng.choice([1.0, 2.0, np.nan], n),
        "Competition": rng.normal(1000, 300, n),
        "Customers": rng.normal(500, 50, n),
        "Open": rng.integers(0, 2, n),
    })
    df.loc[rng.random(n) < 0.1, "Competition"] = np.nan
    df["Sales"] = (df["Customers"] * 8 + rng.normal(0, 20, n)).astype(
        np.float32)
    return df


def test_add_datepart_matches_jax():
    a, b = _frame(), _frame()
    jst.add_datepart(a, "Date")
    st.add_datepart(b, "Date")
    pd.testing.assert_frame_equal(b, a)


@pytest.mark.parametrize("groupby", [None, "Store"])
def test_time_before_after_matches_jax(groupby):
    df = _frame()
    df["Date"] = pd.to_datetime(df["Date"])
    df["Day"] = (df["Date"] - df["Date"].min()).dt.days
    kw = dict(index_col="Day" if groupby is None else None,
              groupby_col=groupby)
    src = df if groupby is None else df.set_index("Day")
    want = jst.get_TimeBeforeAfter(src.copy(), "Promo", **kw)
    got = st.get_TimeBeforeAfter(src.copy(), "Promo", **kw)
    pd.testing.assert_frame_equal(got, want)


@pytest.mark.parametrize("groupby", [None, "Store"])
def test_rolling_stats_matches_jax(groupby):
    df = _frame()
    df["Date"] = pd.to_datetime(df["Date"])
    df = df.drop_duplicates(["Date"]) if groupby is None else df
    kw = dict(index_col="Date", groupby_col=groupby)
    want = jst.get_RollingStats(df.copy(), ["Promo", "Customers"], "3D",
                                ["Sum", "Mean", "Std"], **kw)
    got = st.get_RollingStats(df.copy(), ["Promo", "Customers"], "3D",
                              ["Sum", "Mean", "Std"], **kw)
    pd.testing.assert_frame_equal(got, want)


CAT = ["Store", "StoreType", "Assortment", "Open"]
CONT = ["Competition", "Customers", "Sales"]


@pytest.mark.parametrize("output_var", ["Sales", "Open"])
def test_process_dataframe_matches_jax(output_var):
    train, val = _frame(120, 0), _frame(60, 1)
    val.loc[0, "StoreType"] = "z"                         # an unseen level
    want = jst.ProcessDataFrame(train.copy(), CAT, CONT, output_var, "by_df")
    got = st.ProcessDataFrame(train.copy(), CAT, CONT, output_var, "by_df")
    for g, w in zip(got[:2], want[:2]):
        pd.testing.assert_frame_equal(g, w)
    np.testing.assert_array_equal(got[2], want[2])
    assert got[3] == want[3] and got[4] == want[4]
    vw = jst.ProcessDataFrame(val.copy(), CAT, CONT, output_var, want[3],
                              category_labels=want[4])
    vg = st.ProcessDataFrame(val.copy(), CAT, CONT, output_var, got[3],
                             category_labels=got[4])
    pd.testing.assert_frame_equal(vg[0], vw[0])
    pd.testing.assert_frame_equal(vg[1], vw[1])
    assert vg[0]["StoreType"].iloc[0] == 0        # 'unknown'


def _dataobjs(output_var, bs=16):
    out = []
    for mod in (jst, st):
        tr, va = _frame(120, 0), _frame(60, 1)
        out.append(mod.StructuredDataObj.from_dataframes(
            tr, va, CAT, CONT, output_var, bs, seed=0))
    return out


def test_dataset_takes_plain_arrays():
    dj, dp = _dataobjs("Sales")
    np.testing.assert_array_equal(dp.train_ds.x_cat, dj.train_ds.x_cat)
    np.testing.assert_array_equal(dp.val_ds.x_cont, dj.val_ds.x_cont)
    ds = st.StructuredDataset(dp.train_ds.x_cat, dp.train_ds.x_cont,
                              dp.train_ds.y, "cont")
    assert (ds.n_cat, ds.n_cont) == (4, 2)
    for a, b in zip(ds[5], dp.train_ds[5]):
        np.testing.assert_array_equal(a, b)
    no_cont = st.StructuredDataset(dp.train_ds.x_cat, None, None, "cont")
    assert no_cont.n_cont == 0 and no_cont.x_cont.shape == (120, 1)
    assert [st.embedding_dim(n) for n in (2, 9, 13, 19, 51, 500)] == [
        jst.embedding_dim(n) for n in (2, 9, 13, 19, 51, 500)]


def _net_pair(dj, dp, head=(8, 1), output_range=(0.0, 6000.0), seed=0):
    jm = jst.StructuredDataNet.from_dataobj(dj, head,
                                            output_range=output_range)
    b = dj.train_dl.peek()
    variables = _np(jm.init(jax.random.PRNGKey(seed), *b.xs))
    pm = st.StructuredDataNet.from_dataobj(dp, head,
                                           output_range=output_range,
                                           device="cpu")
    load_jax_params(pm, variables["params"],
                    batch_stats=variables["batch_stats"])
    return jm, variables, pm, b


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("target", ["cont", "cat"])
def test_net_matches_jax(target, train):
    dj, dp = _dataobjs("Sales" if target == "cont" else "Open")
    head = (8, 1) if target == "cont" else (8, 2)
    jm, variables, pm, b = _net_pair(dj, dp, head)
    n_cat = 4 if target == "cont" else 3         # 'Open' is the target
    assert pm.layer_group_prefixes == (
        tuple(f"embeddings_{i}" for i in range(n_cat)) + ("cont_bn",),
        ("head",))
    xs = [torch.from_numpy(np.asarray(x)) for x in b.xs]
    if train:
        want, mut = jm.apply(variables, *b.xs, train=True,
                             mutable=["batch_stats"])
    else:
        want = jm.apply(variables, *b.xs)
    got = pm(*xs, train=train)
    assert got.shape == ((16,) if target == "cont" else (16, 2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    if train:      # the running statistics JAX's batch_stats hold
        stats = _np(mut["batch_stats"])
        bufs = dict(pm.named_buffers())
        for path in (("cont_bn",), ("head", "lins_0", "bn")):
            node = stats
            for k in path:
                node = node[k]
            for leaf in ("mean", "var"):
                np.testing.assert_allclose(
                    bufs[".".join(path) + ".running_" + leaf].numpy(),
                    node[leaf], rtol=0, atol=1e-6)


def test_embedding_drop_max_norm_gradient_matches_jax():
    """Rows with norms past max_norm are rescaled as a function of the
    table, so the gradient passes through the norm (torch's
    nn.Embedding(max_norm=) would renormalise in place instead)."""
    rng = np.random.default_rng(3)
    table = rng.normal(0, 1.0, (7, 5)).astype(np.float32)
    table[2] *= 0.1                           # one row under max_norm
    idx = np.array([0, 2, 2, 5, 6, 0], np.int32)
    w = rng.normal(0, 1, (6, 5)).astype(np.float32)
    jemb = jlayers.EmbeddingDrop(7, 5, 0.0, max_norm=1.5)

    def f(t):
        rows = jemb.apply({"params": {"emb": {"embedding": t}}}, idx)
        return jnp.sum(jnp.sin(rows) * w)

    want_v, want_g = jax.value_and_grad(f)(jnp.asarray(table))
    pemb = layers.EmbeddingDrop(7, 5, 0.0, max_norm=1.5)
    with torch.no_grad():
        pemb.emb.embedding.copy_(torch.from_numpy(table))
    got_v = (torch.sin(pemb(torch.from_numpy(idx).long()))
             * torch.from_numpy(w)).sum()
    got_v.backward()
    assert float(got_v.detach()) == pytest.approx(float(want_v), rel=1e-6)
    np.testing.assert_allclose(pemb.emb.embedding.grad.numpy(),
                               np.asarray(want_g), rtol=0, atol=1e-6)
    rows = pemb(torch.from_numpy(idx).long()).detach()
    assert float(rows.norm(dim=1).max()) <= 1.5 + 1e-6
    # per-sample dropout: whole vectors kept or zeroed, kept ones scaled
    pemb.drop = 0.5
    out = pemb(torch.arange(7).repeat(40), train=True,
               generator=torch.Generator().manual_seed(0)).detach()
    base = pemb(torch.arange(7).repeat(40)).detach()
    ratio = out / base
    assert set(torch.unique(torch.round(ratio[:, 0] * 4) / 4).tolist()) <= {
        0.0, 2.0}
    assert torch.equal(ratio.amin(1) == ratio.amax(1),
                       torch.ones(280, dtype=torch.bool))


def test_embedding_init_is_truncated_normal():
    emb = layers.Embedding(4000, 10, std=0.5)
    t = emb.embedding.detach()
    assert float(t.abs().max()) < 1.0 and abs(float(t.std()) - 0.45) < 0.03


def test_ensemble_with_cat_correction_matches_jax():
    dj, dp = _dataobjs("Open")
    pairs = [_net_pair(dj, dp, (8, 2), None, seed) for seed in (0, 1)]
    jens = jst.StructuredDataEnsembleNet(tuple(p[0] for p in pairs),
                                         weights=(0.25, 0.75),
                                         correction="cat")
    jvars = {k: {f"models_{i}": p[1][k] for i, p in enumerate(pairs)}
             for k in ("params", "batch_stats")}
    b = pairs[0][3]
    want = jens.apply(jvars, *b.xs)
    pens = st.StructuredDataEnsembleNet([p[2] for p in pairs],
                                        weights=(0.25, 0.75),
                                        correction="cat")
    got = pens(*[torch.from_numpy(np.asarray(x)) for x in b.xs])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-6)
    np.testing.assert_allclose(got.sum(1).detach().numpy(), 1.0, rtol=1e-6)


def test_cat_learner_evaluate_gives_loss_and_accuracy_as_jax():
    """A 'cat' target: evaluate('val') is [loss, accuracy] in both
    packages, then one train step moves the same way."""
    dj, dp = _dataobjs("Open")
    jm, variables, pm, _ = _net_pair(dj, dp, (8, 2), None)
    jl = JaxLearner(tempfile.mkdtemp(), dj, jm, "Adam2", mesh=get_mesh(1))
    jl.params = pmesh.shard_params(variables["params"], jl.mesh,
                                   jl.param_sharding)
    jl.state = pmesh.replicate_tree({"batch_stats": variables["batch_stats"]},
                                    jl.mesh)
    pl = Learner(tempfile.mkdtemp(), dp, pm, "Adam2", device="cpu")
    want, got = jl.evaluate("val"), pl.evaluate("val")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-12)
    probs, labels = pl.predict("val")
    jprobs, jlabels = jl.predict("val")
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, jlabels)
    jb, pb = dj.train_dl.peek(), dp.train_dl.peek()
    np.testing.assert_allclose(float(pl.train1minibatch(pb, 1e-3)),
                               float(jl.train1minibatch(jb, 1e-3)),
                               rtol=1e-5)
