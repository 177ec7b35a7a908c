"""Collaborative filtering (applications/collab.py) against the JAX package
on the CPU.

A MovieLens-shaped synthetic table (as examples/movielens.py makes it)
cut to 600 ratings of 30 users and 50 items.  Weights are the JAX
model's, carried by ``load_jax_params``.  Tolerances, float32: relabeling
and splits exactly; forwards atol 1e-5; a one-epoch ``fit_one_cycle``'s
per-step losses rtol 1e-4 and its val loss rtol 1e-4.
"""

import tempfile

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from neuralnetworklibrary_tpu.applications import collab as jcollab
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.applications import collab
from neuralnetworklibrary_tpu_torch.core.pytree import combine_preds
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params

N_RATINGS, USERS, ITEMS, EMB, BS = 600, 30, 50, 4, 64


def _ratings(seed=0):
    """examples/movielens.py's synthetic_ratings at a small size, with
    string-free but scattered raw ids (ids 1000 + 7 k)."""
    rng = np.random.default_rng(seed)
    u_bias = rng.normal(0, 0.5, USERS)
    i_bias = rng.normal(0, 0.5, ITEMS)
    u = rng.integers(0, USERS, N_RATINGS)
    i = rng.integers(0, ITEMS, N_RATINGS)
    r = np.clip(3.2 + u_bias[u] + i_bias[i] + rng.normal(0, 0.8, N_RATINGS),
                0.5, 5.0)
    return pd.DataFrame({"userId": 1000 + 7 * u, "movieId": 5000 - 3 * i,
                         "rating": r.astype(np.float32)})


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tree)


@pytest.mark.parametrize("frame", ["dataframe", "dict_of_arrays"])
def test_relabeling_and_split_match_jax(frame):
    df = _ratings()
    want = jcollab.CollabFilterDataObj.from_dataframes(
        df.copy(), "userId", "movieId", "rating", BS, seed=0)
    src = (df.copy() if frame == "dataframe"
           else {c: df[c].to_numpy() for c in df.columns})
    got = collab.CollabFilterDataObj.from_dataframes(
        src, "userId", "movieId", "rating", BS, seed=0)
    assert got.labels == want.labels
    assert list(got.labels[0].values()) == list(range(len(got.labels[0])))
    for g, w in ((got.train_ds, want.train_ds), (got.val_ds, want.val_ds)):
        np.testing.assert_array_equal(g.x, w.x)
        np.testing.assert_array_equal(g.y, w.y)
        assert g.y_range == w.y_range
    assert len(got.val_ds) == int(N_RATINGS * 0.2)
    assert got.target_type == "cont"
    with pytest.raises(KeyError, match="without a label"):
        collab.CollabFilterDataset({"u": np.array([1, 999]),
                                    "i": np.array([0, 0]),
                                    "r": np.ones(2)}, "u", "i", "r",
                                   [{1: 0}, {0: 0}])


def test_from_csv_and_test_set(tmp_path):
    df = _ratings(1)
    df.to_csv(tmp_path / "r.csv", index=False)
    df.iloc[:40, :2].to_csv(tmp_path / "t.csv", index=False)
    got = collab.CollabFilterDataObj.from_csv(
        str(tmp_path / "r.csv"), "userId", "movieId", "rating", BS,
        test_csv=str(tmp_path / "t.csv"))
    want = jcollab.CollabFilterDataObj.from_csv(
        str(tmp_path / "r.csv"), "userId", "movieId", "rating", BS,
        test_csv=str(tmp_path / "t.csv"))
    np.testing.assert_array_equal(got.test_ds.x, want.test_ds.x)
    assert (got.test_ds.y == 0).all() and len(got.test_dl) == 1


def _nets(data_j, data_p, seed=0):
    jm = jcollab.CollabFilterNet.from_dataobj(data_j, EMB)
    x = data_j.val_ds.x[:8]
    params = _np(jm.init(jax.random.PRNGKey(seed), x)["params"])
    pm = collab.CollabFilterNet.from_dataobj(data_p, EMB, device="cpu")
    assert pm.output_range == pytest.approx(jm.output_range)
    load_jax_params(pm, params)
    return jm, params, pm


def _both_data():
    df = _ratings()
    return (jcollab.CollabFilterDataObj.from_dataframes(
                df.copy(), "userId", "movieId", "rating", BS, seed=0),
            collab.CollabFilterDataObj.from_dataframes(
                df.copy(), "userId", "movieId", "rating", BS, seed=0))


def test_net_and_ensemble_match_jax():
    data_j, data_p = _both_data()
    members = [_nets(data_j, data_p, seed) for seed in (0, 1)]
    x = data_j.val_ds.x
    xt = torch.from_numpy(x).long()
    for jm, params, pm in members:
        np.testing.assert_allclose(pm(xt).detach().numpy(),
                                   np.asarray(jm.apply({"params": params}, x)),
                                   atol=1e-5)
    # members under models_<i>: ensemble_params merges the members' trees
    jens = jcollab.CollabFilterEnsembleNet(tuple(m[0] for m in members),
                                           weights=(0.3, 0.7))
    want = jens.apply({"params": jcollab.ensemble_params(
        [m[1] for m in members])}, x)
    fresh = [collab.CollabFilterNet.from_dataobj(data_p, EMB, device="cpu")
             for _ in members]
    pens = collab.CollabFilterEnsembleNet(fresh, weights=(0.3, 0.7))
    pens.load_state_dict(collab.ensemble_params(
        [m[2].state_dict() for m in members]))
    got = pens(xt).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)
    preds = [m[2](xt).detach().numpy() for m in members]
    np.testing.assert_allclose(combine_preds(preds, "cont", (0.3, 0.7)),
                               got, atol=1e-6)


def test_combine_preds_kinds():
    a = np.array([[0.2, 0.8], [0.6, 0.4]])
    b = np.array([[0.6, 0.4], [0.8, 0.2]])
    probs, labels = combine_preds([a, b], "cat")
    np.testing.assert_allclose(probs, [[0.4, 0.6], [0.7, 0.3]])
    np.testing.assert_array_equal(labels, [1, 0])
    _, rounded = combine_preds([a, b], "multi_label")
    np.testing.assert_array_equal(rounded, [[0, 1], [1, 0]])
    with pytest.raises(ValueError):
        combine_preds([a], "bbox")


def test_fit_one_cycle_matches_jax():
    """One epoch of 1cycle (bs 64, 8 steps with a short last batch),
    Adam2, wd 1e-4, then evaluate and predict."""
    data_j, data_p = _both_data()
    jm, params, pm = _nets(data_j, data_p)
    jl = JaxLearner(tempfile.mkdtemp(), data_j, jm, "Adam2",
                    mesh=get_mesh(1))
    from neuralnetworklibrary_tpu.parallel import mesh as pmesh

    jl.params = pmesh.shard_params(params, jl.mesh, jl.param_sharding)
    jl.opt_state = jl.optimizer.init(jl.params)
    pl = Learner(tempfile.mkdtemp(), data_p, pm, "Adam2", device="cpu")
    jl.fit_one_cycle(0.01, 1, wd=1e-4)
    pl.fit_one_cycle(0.01, 1, wd=1e-4)
    want = np.asarray([float(v) for v in jl.loss_sched])
    got = np.asarray([float(v) for v in pl.loss_sched])
    assert len(got) == len(want) == len(data_p.train_dl) == 8
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # 'cont' targets: evaluate gives [loss], no accuracy
    gv, wv = pl.evaluate("val"), jl.evaluate("val")
    assert len(gv) == len(wv) == 1
    np.testing.assert_allclose(gv[0], wv[0], rtol=1e-4)
    np.testing.assert_allclose(pl.predict("val"), jl.predict("val"),
                               rtol=0, atol=1e-4)
