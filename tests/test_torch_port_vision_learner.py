"""Port of the vision Learner path (learner.py's input pipeline,
bn_freeze, set_trainable, evaluate accuracy and predict;
applications/vision.py's transforms and ImageLearner) against the JAX
package on the CPU.

A resnet18 ``ImageClassificationNet`` (head [16], no dropout) at 32 px on
8 synthetic uint8 images of 4 classes, bs 4, with a ``normalize_batch``
input pipeline.  One JAX Learner is built (its init compiles for
seconds); each test restores its starting params and state.  The port's
Learner starts from the same params and batch_stats
(``load_jax_params``).  Tolerances, float32: per-step losses rtol 1e-4;
evaluate's loss rtol 1e-5 and its accuracy exactly; predict's
probabilities atol 1e-5 and its labels exactly; BatchNorm running
statistics after the three steps rtol 1e-3, atol 1e-4 (see the test).
"""

import subprocess
import sys
import tempfile
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import vision as jvision
from neuralnetworklibrary_tpu.data import loader as jloader
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.ops import augment as jaug
from neuralnetworklibrary_tpu.parallel import mesh as pmesh
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.applications import vision
from neuralnetworklibrary_tpu_torch.data import loader
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.ops import augment as aug
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params

ROOT = Path(__file__).resolve().parents[1]
N, PX, NCLS, BS = 8, 32, 4, 4
HEAD = ([16], (0.0, 0.0))
_rng = np.random.default_rng(0)
IMGS = _rng.integers(0, 256, (N, PX, PX, 3), dtype=np.uint8)
LABELS = _rng.integers(0, NCLS, N).astype(np.int32)


def _data(mod):
    ds = mod.ArrayDataset(IMGS, LABELS)
    return types.SimpleNamespace(
        target_type="single_label", bs=BS,
        categories={i: str(i) for i in range(NCLS)},
        train_dl=mod.DataLoader(ds, BS, prefetch=0),
        val_dl=mod.DataLoader(ds, BS, prefetch=0))


def _jax_pipe(key, xs, train):
    return (jaug.normalize_batch(xs[0], jaug.imagenet_stats),) + tuple(
        xs[1:])


def _pipe(generator, xs, train):
    return (aug.normalize_batch(xs[0], aug.imagenet_stats),) + tuple(xs[1:])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_learner():
    data = _data(jloader)
    model = jvision.ImageClassificationNet.create(data, "resnet18",
                                                  head=HEAD)
    jl = JaxLearner(tempfile.mkdtemp(), data, model, "Adam2",
                    mesh=get_mesh(1), input_pipeline=_jax_pipe)
    return jl, _np(jl.params), _np(jl.state)


def _fresh(jax_learner):
    """The JAX Learner at its starting params and state (its train step
    donates their buffers, so they are put back from numpy copies),
    unfrozen, and a port Learner on the same weights."""
    jl, params, state = jax_learner
    jl.params = pmesh.shard_params(params, jl.mesh, jl.param_sharding)
    jl.state = pmesh.replicate_tree(state, jl.mesh)
    jl.unfreeze()
    jl.bn_unfreeze()
    jl.set_trainable(None)
    data = _data(loader)
    torch.manual_seed(0)
    model = vision.ImageClassificationNet.create(data, "resnet18", head=HEAD,
                                                 device="cpu")
    load_jax_params(model, params, batch_stats=state["batch_stats"])
    pl = Learner(tempfile.mkdtemp(), data, model, "Adam2",
                 input_pipeline=_pipe, device="cpu")
    return jl, pl


def _in_layer4_or_head(path):
    return path[0] == "head" or path[1].startswith("layer4")


def _set(learner, config):
    if config == "freeze":
        learner.freeze()
    elif config == "bn_freeze_non_head":
        learner.bn_freeze("non_head")
    else:
        learner.set_trainable(_in_layer4_or_head)


LR = 1e-5


@pytest.mark.parametrize("config", ["freeze", "bn_freeze_non_head",
                                    "set_trainable"])
def test_loss_trajectory_matches_jax(jax_learner, config):
    """Three Adam2 steps (wd 1e-4) at lr 1e-5 on batches 0, 1, 0.

    At this size the trajectory is chaotic at larger rates: Adam's first
    step moves every trained parameter by +-lr by the sign of its
    gradient, and float32 gradients through train-mode BatchNorms over 4
    samples of 1x1 maps lose up to ~1e-2 of max|grad| against float64, in
    either package, so the signs of the smallest gradients differ and the
    runs part.  At lr 1e-3 the port in float32 and the port in float64
    differ by up to 27% at step 3, as much as the two packages do; in
    float64 the two packages' gradients of one step agree to 5e-13 with
    no sign differing.  At lr 1e-5 one step still moves the loss by half
    (2.17 -> 1.02 on the next batch)."""
    jl, pl = _fresh(jax_learner)
    for learner in (jl, pl):
        _set(learner, config)
        learner.init_optimizer(wd=1e-4)
    before = {n: t.detach().clone() for n, t in
              list(pl.model.named_parameters())
              + list(pl.model.named_buffers())}
    want, got = [], []
    for batch_j, batch_p in zip(list(jl.data.train_dl) * 2,
                                list(pl.data.train_dl) * 2):
        want.append(float(jl.train1minibatch(batch_j, LR)))
        got.append(float(pl.train1minibatch(batch_p, LR)))
        if len(got) == 3:
            break
    np.testing.assert_allclose(got, want, rtol=1e-4)
    # the running statistics, as JAX's batch_stats (looser than the nets'
    # 1e-5: Adam's first steps move each trained parameter by about lr
    # whatever the size of its gradient, so float32 round-off in small
    # gradients reaches the parameters, and the statistics after them)
    bufs = dict(pl.model.named_buffers())
    for name, arr in jax.tree_util.tree_leaves_with_path(
            _np(jl.state["batch_stats"])):
        keys = [k.key for k in name]
        port = bufs[".".join(keys[:-1]) + ".running_" + keys[-1]]
        np.testing.assert_allclose(port.numpy(), arr, rtol=1e-3, atol=1e-4)
    # what must not move, did not
    trainable = dict(zip([".".join(p) for p in pl.partition.paths],
                         pl._trainable()))
    for n, t in pl.model.named_parameters():
        assert torch.equal(t, before[n]) != trainable[n], n
    if config == "bn_freeze_non_head":
        for n, t in pl.model.named_buffers():
            if n.startswith("body.") and "running" in n:
                assert torch.equal(t, before[n]), n
    if config == "freeze":  # plain freeze() still trains the body's stats
        assert not torch.equal(bufs["body.stem.bn.running_mean"],
                               before["body.stem.bn.running_mean"])


def test_evaluate_and_predict_match_jax(jax_learner):
    jl, pl = _fresh(jax_learner)
    got, want = pl.evaluate("val"), jl.evaluate("val")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert got[1] == want[1]
    probs, labels = pl.predict(pl.data.val_dl)
    jprobs, jlabels = jl.predict(jl.data.val_dl)
    assert probs.shape == (N, NCLS)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_allclose(pl.predict1minibatch(IMGS[:BS]).numpy(),
                               np.asarray(jl.predict1minibatch(IMGS[:BS])),
                               rtol=0, atol=1e-4)


def test_multi_label_accuracy_and_predict():
    """evaluate gives the elementwise accuracy of rounded sigmoids over
    count x C, predict the sigmoids and their rounding."""
    class Net(torch.nn.Module):
        def forward(self, x, train=False):
            return x.float()

    logits = np.array([[2.0, -1.0, 0.5], [-3.0, 1.0, -0.2]], np.float32)
    y = np.array([[1, 0, 0], [0, 1, 1]], np.float32)
    ds = loader.ArrayDataset(logits, y)
    data = types.SimpleNamespace(target_type="multi_label", bs=2,
                                 categories={0: "a", 1: "b", 2: "c"},
                                 train_dl=loader.DataLoader(ds, 2),
                                 val_dl=loader.DataLoader(ds, 2))
    pl = Learner(tempfile.mkdtemp(), data, Net(), device="cpu")
    loss, acc = pl.evaluate("val")
    assert acc == pytest.approx(4 / 6)
    probs, labels = pl.predict("val")
    np.testing.assert_allclose(probs, 1 / (1 + np.exp(-logits)), rtol=1e-6)
    np.testing.assert_array_equal(labels, [[1, 0, 1], [0, 1, 0]])


def test_uint8_batches_reach_the_pipeline_as_uint8():
    data = _data(loader)
    seen = []

    def spy(generator, xs, train):
        seen.append((xs[0].dtype, train, generator.device.type))
        return _pipe(generator, xs, train)

    model = vision.ImageClassificationNet.create(data, "resnet18", head=HEAD,
                                                 device="cpu")
    pl = Learner(tempfile.mkdtemp(), data, model, "Adam2",
                 input_pipeline=spy, device="cpu")
    batch = data.train_dl.peek()
    xs, y, mask = pl._to_device(batch)
    assert xs[0].dtype == torch.uint8
    assert y.dtype == torch.int64 and mask.dtype == torch.float32
    pl.train1minibatch(batch, 1e-3)
    pl.evaluate("val")
    pl.predict1minibatch(IMGS[:2])
    assert seen[0] == (torch.uint8, True, "cpu")
    assert all(s[0] == torch.uint8 for s in seen)
    assert {s[1] for s in seen} == {True, False}


def test_transforms_and_image_learner():
    tfm_eval, tfm_aug = vision.get_transforms("SideOn", PX)
    img = IMGS[0]
    np.testing.assert_array_equal(tfm_eval(img), img)
    wide = np.concatenate([img, img[:, :8]], axis=1)         # 32 x 40
    np.testing.assert_array_equal(tfm_eval(wide), wide[:, 4:36])
    padded = vision.Transform("Basic", "center", pad=2, sz=None,
                              max_deg=None)(img)
    np.testing.assert_array_equal(padded[2:-2, 2:-2], img)
    np.testing.assert_array_equal(padded[:2, 2:-2], img[1::-1])  # reflect
    with pytest.raises(NotImplementedError, match="rotate"):
        tfm_aug(img)
    with pytest.raises(NotImplementedError, match="resize"):
        vision.Transform("Basic", None, sz=16, max_deg=None)(img)

    data = _data(loader)
    data.transforms = [tfm_eval, tfm_aug]
    model = vision.ImageClassificationNet.create(data, "resnet18", head=HEAD,
                                                 device="cpu")
    il = vision.ImageLearner(tempfile.mkdtemp(), data, model, "Adam2",
                             device="cpu")
    assert il.compute_dtype == torch.bfloat16
    x = torch.from_numpy(IMGS[:2])
    out_eval = il.input_pipeline(il.pipeline_generator, (x,), False)[0]
    torch.testing.assert_close(
        out_eval, aug.normalize_batch(x, aug.imagenet_stats))
    g = torch.Generator().manual_seed(3)
    out_aug = il.input_pipeline(g, (x,), True)[0]
    want = aug.augment_batch(torch.Generator().manual_seed(3), x,
                             tfm_type="SideOn", max_deg=None, max_zoom=None)
    torch.testing.assert_close(out_aug, want)
    il.switch_transform_stats(aug.alternate_stats)
    out_alt = il.input_pipeline(il.pipeline_generator, (x,), False)[0]
    torch.testing.assert_close(
        out_alt, aug.normalize_batch(x, aug.alternate_stats))
    loss = il.train1minibatch(data.train_dl.peek(), 1e-3)
    assert torch.isfinite(loss)


def test_port_modules_leave_jax_unloaded():
    """Importing every module of the port and chip_smoke.py loads neither
    jax nor the JAX package (jax is importable here, and not blocked), nor
    pandas, sklearn, matplotlib, cv2, transformers or safetensors, which
    the card's machine lacks."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import neuralnetworklibrary_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(
            pkg.__path__, pkg.__name__ + ".")]
        for name in names + ["chip_smoke"]:
            importlib.import_module(name)
        roots = ("jax", "flax", "neuralnetworklibrary_tpu", "pandas",
                 "sklearn", "matplotlib", "cv2", "transformers",
                 "safetensors")
        bad = [m for m in sys.modules if m.split(".")[0] in roots]
        assert not bad, bad
        for app in ("vision", "text", "collab", "structured", "detection"):
            assert f"neuralnetworklibrary_tpu_torch.applications.{app}" in names
        print("ok", len(names))
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("correction", ["single_label", "multi_label"])
def test_ensemble_averages_corrected_outputs(correction):
    """ImageClassificationEnsembleNet: the weighted mean of the members'
    softmax (sigmoid for 'multi_label') outputs, as in JAX (Vision.py:
    1339-1373)."""
    class Scale(torch.nn.Module):
        def __init__(self, c):
            super().__init__()
            self.c = c

        def forward(self, x, train=False, bn_frozen=None):
            return x * self.c

    x = torch.randn(3, 4)
    ens = vision.ImageClassificationEnsembleNet([Scale(1.0), Scale(2.0)],
                                                weights=(0.25, 0.75),
                                                correction=correction)
    act = ((lambda t: torch.softmax(t, 1)) if correction == "single_label"
           else torch.sigmoid)
    torch.testing.assert_close(ens(x), 0.25 * act(x) + 0.75 * act(2 * x))
    assert isinstance(ens.models_1, Scale)
