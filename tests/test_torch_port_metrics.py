"""The port's losses and metrics (core/metrics.py) and the Learner's end
metrics against the JAX package on the CPU.

Every loss and metric takes the same numpy-seeded inputs, with and
without a row mask, in float32: values within rtol 1e-6.  ``AUC`` is
held to the JAX package's, which calls sklearn's ``roc_auc_score``, on
scores with many ties, within 1e-12.  A two-class linear model through
both Learners gives the same ``evaluate('val', [batch metric, 'auc',
batch metric])`` (losses rtol 1e-5, metric values 1e-6).
"""

import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.core import metrics as jm
from neuralnetworklibrary_tpu.data import loader as jloader
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.core import metrics as pm
from neuralnetworklibrary_tpu_torch.data import loader
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params

_rng = np.random.default_rng(0)
N, C = 12, 5
LOGITS = _rng.normal(0, 2, (N, C)).astype(np.float32)
LABELS = _rng.integers(0, C, N).astype(np.int32)
MULTI = (_rng.random((N, C)) < 0.4).astype(np.float32)
POS = _rng.uniform(0.5, 3.0, N).astype(np.float32)      # regression targets
PRED = (POS * _rng.uniform(0.8, 1.25, N)).astype(np.float32)
SEQ = _rng.normal(0, 1, (3, 7, C)).astype(np.float32)
SEQ_Y = _rng.integers(0, C, (3, 7)).astype(np.int32)
MASK = (np.arange(N) < 9).astype(np.float32)


def _both(fn_j, fn_p, args, mask):
    want = float(fn_j(*[jnp.asarray(a) for a in args],
                      None if mask is None else jnp.asarray(mask)))
    got = float(fn_p(*[torch.from_numpy(a) for a in args],
                     None if mask is None else torch.from_numpy(mask)))
    return got, want


CASES = {
    "mse_loss": (jm.mse_loss, pm.mse_loss, (PRED, POS)),
    "cross_entropy_loss": (jm.cross_entropy_loss, pm.cross_entropy_loss,
                           (LOGITS, LABELS)),
    "label_smoothing": (jm.LabelSmoothingCrossEntropy(0.1),
                        pm.LabelSmoothingCrossEntropy(0.1),
                        (LOGITS, LABELS)),
    "bce_with_logits": (jm.bce_with_logits_loss, pm.bce_with_logits_loss,
                        (LOGITS, MULTI)),
    "MSPE_loss": (jm.MSPE_loss, pm.MSPE_loss, (PRED, POS)),
    "logMSE_loss": (jm.logMSE_loss, pm.logMSE_loss, (PRED, POS)),
    "expMSPE_loss": (jm.expMSPE_loss, pm.expMSPE_loss,
                     (np.log(PRED), np.log(POS))),
    "accuracy": (jm.accuracy, pm.accuracy, (LOGITS, LABELS)),
    "multi_label_accuracy": (jm.multi_label_accuracy,
                             pm.multi_label_accuracy, (LOGITS, MULTI)),
    "fbeta_thresh": (jm.fbeta_loss(2.0), pm.fbeta_loss(2.0),
                     (LOGITS, MULTI)),
    "fbeta_probs": (jm.fbeta_loss(0.5, use_thresh=False),
                    pm.fbeta_loss(0.5, use_thresh=False),
                    (1 / (1 + np.exp(-LOGITS)), MULTI)),
    "kPrecision_1": (jm.kPrecision(1), pm.kPrecision(1), (LOGITS, LABELS)),
    "kPrecision_3": (jm.kPrecision(3), pm.kPrecision(3), (LOGITS, LABELS)),
}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_or_metric_matches_jax(name, masked):
    fn_j, fn_p, args = CASES[name]
    got, want = _both(fn_j, fn_p, args, MASK if masked else None)
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_label_smoothing_over_sequences(masked):
    mask = (np.arange(3) < 2).astype(np.float32) if masked else None
    got, want = _both(jm.LabelSmoothingCrossEntropy(0.2),
                      pm.LabelSmoothingCrossEntropy(0.2), (SEQ, SEQ_Y), mask)
    assert got == pytest.approx(want, rel=1e-6)


def test_loss_func_dict_covers_jax_target_types():
    assert set(pm.loss_func_dict) == set(jm.loss_func_dict)
    for key, fn in jm.loss_func_dict.items():
        assert pm.loss_func_dict[key].__name__ == fn.__name__


@pytest.mark.parametrize("levels", [3, 11, 1000])
def test_auc_with_ties_matches_sklearn(levels):
    """Scores rounded to ``levels`` distinct values (3: nearly all tied)."""
    rng = np.random.default_rng(levels)
    y = rng.integers(0, 2, 400)
    score = np.round(rng.random(400) * (levels - 1) + 0.3 * y) / levels
    got = pm.AUC()(score.astype(np.float32), y.astype(np.int8))
    want = jm.AUC()(score.astype(np.float32), y.astype(np.int8))
    assert got == pytest.approx(want, abs=1e-12)
    logits = rng.normal(0, 1, (50, 2)).astype(np.float32)
    lab = rng.integers(0, 2, 50)
    for a, b in zip(pm.AUC().prepare(logits, lab),
                    jm.AUC().prepare(logits, lab)):
        np.testing.assert_array_equal(a, b)
    assert pm.AUC()(logits, lab) == pytest.approx(jm.AUC()(logits, lab),
                                                  abs=1e-12)


def test_average_ranks_and_one_class():
    np.testing.assert_array_equal(pm.average_ranks([3.0, 1.0, 3.0, 2.0]),
                                  [3.5, 1.0, 3.5, 2.0])
    with pytest.raises(ValueError, match="both classes"):
        pm.AUC()(np.ones(4, np.float32), np.ones(4, np.int8))
    assert pm.is_end_metric("auc") and pm.is_end_metric(pm.AUC())
    assert not pm.is_end_metric(pm.accuracy)


class _Linear(torch.nn.Module):
    """flax ``nn.Dense(2)`` under its auto name ``Dense_0``."""

    def __init__(self, n_in):
        super().__init__()
        self.Dense_0 = torch.nn.Linear(n_in, 2)

    def forward(self, x, train=False):
        return self.Dense_0(x)


def test_learner_end_metrics_match_jax():
    import flax.linen as fnn

    class JLinear(fnn.Module):
        @fnn.compact
        def __call__(self, x, train=False):
            return fnn.Dense(2)(x)

    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (22, 6)).astype(np.float32)
    y = (x[:, 0] + rng.normal(0, 1, 22) > 0).astype(np.int32)

    def data(mod):
        ds = mod.ArrayDataset(x, y)
        return types.SimpleNamespace(
            target_type="single_label", bs=8,
            train_dl=mod.DataLoader(ds, 8, prefetch=0),
            val_dl=mod.DataLoader(ds, 8, prefetch=0))

    jl = JaxLearner(tempfile.mkdtemp(), data(jloader), JLinear(), "Adam2",
                    mesh=get_mesh(1))
    model = load_jax_params(_Linear(6), jax.tree_util.tree_map(
        np.asarray, jl.params))
    pl = Learner(tempfile.mkdtemp(), data(loader), model, "Adam2",
                 device="cpu")
    metrics_j = [jm.accuracy, "auc", jm.kPrecision(1)]
    metrics_p = [pm.accuracy, "auc", pm.kPrecision(1)]
    want = jl.evaluate("val", metrics_j)
    got = pl.evaluate("val", metrics_p)
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == pytest.approx(want[1], abs=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-6)
    assert got[2][1] == pytest.approx(jm.AUC()(
        np.asarray(jl.predict1minibatch(x)), y), abs=1e-6)
