"""The port's detection workload (applications/detection.py's data,
ObjectDetectionLearner, predict, mAP, COCO evaluation, TTA and device
cache; learner.py's tuple targets and 'bbox' evaluation) against the JAX
package on the CPU.

Data: synthetic COCO jsons written with cv2 (bright rectangles on dark
noise): 6 images of varied heights for the loaders, 8 of one size (64 x
96) for the Learner, at bench.py's SMOKE shape (ARS (64, 128),
granularity 32, B 2).  Model: RetinaNet-resnet18 at feature 16, 2
classes; one JAX ObjectDetectionLearner (float32, a one-device mesh) is
built per file, its subnets' output convs filled with random values (at
init they are zero), and the port's Learner starts from the same weights
(``load_jax_params``).  Each test restores the starting weights.

Tolerances: loader batches, groups and canvases bit for bit; three f32
train steps' losses rtol 1e-4 (lr 1e-5: at B 2 and 64 px the BatchNorms
of the last maps normalize over few values, so larger steps grow the
float32 differences chaotically); evaluate's loss and metrics rtol 1e-5;
predictions: the same classes, scores within 1e-5 and boxes within 1e-3
px; mAP and COCO stats within 1e-6.
"""

import json
import tempfile

import jax
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import detection as jdet
from neuralnetworklibrary_tpu.parallel import mesh as pmesh
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.applications import detection as pdet
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params

ARS, GRAN, BS = (64, 128), 32, 2
LR = 1e-5


def _write_coco(root, sizes, seed, n_cats=2):
    import cv2

    (root / "train").mkdir()
    rng = np.random.default_rng(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        for _ in range(int(rng.integers(1, 3))):
            x, y = int(rng.integers(0, w - 24)), int(rng.integers(0, h - 24))
            bw, bh = int(rng.integers(10, 20)), int(rng.integers(10, 20))
            img[y:y + bh, x:x + bw] = rng.integers(150, 256, 3)
            anns.append({"id": len(anns), "image_id": i,
                         "bbox": [x, y, bw, bh],
                         "category_id": int(rng.integers(1, n_cats + 1))})
        cv2.imwrite(str(root / "train" / f"im{i}.png"), img)
        images.append({"id": i, "file_name": f"im{i}.png", "width": w,
                       "height": h})
    with open(root / "train.json", "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": c + 1, "name": f"c{c}"}
                                  for c in range(n_cats)]}, f)
    return root


@pytest.fixture(scope="module")
def varied(tmp_path_factory):
    return _write_coco(tmp_path_factory.mktemp("det_varied"),
                       [(60 + 4 * i, 80) for i in range(6)], 0)


@pytest.fixture(scope="module")
def uniform(tmp_path_factory):
    return _write_coco(tmp_path_factory.mktemp("det_uniform"),
                       [(64, 96)] * 8, 7)


def _data(mod, root, tfm="SideOn", jitter=0, scale_range=(1, 1), photo=True,
          **kw):
    tfms = mod.get_transforms_bbox(tfm, jitter=jitter,
                                   scale_range=scale_range)
    if not photo:
        tfms[1].bal_range = tfms[1].cont_range = None
    tfms[0].seed(1)
    tfms[1].seed(2)
    kw = dict(dict(bs=BS, val_frac=0.5, seed=0), **kw)
    return mod.BBoxDataObj.from_json_bbox(str(root), tfms, get_ARS=ARS,
                                          granularity=GRAN, **kw)


def _same_batch(a, b):
    np.testing.assert_array_equal(a.xs[0], b.xs[0])
    assert a.xs[0].dtype == b.xs[0].dtype == np.uint8
    for x, y in zip(a.y, b.y):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.mask, b.mask)
    assert a.n_valid == b.n_valid


@pytest.mark.parametrize("val_bs", [None, 1])
def test_loader_batches_bit_equal_jax(varied, val_bs):
    kw = dict(jitter=4, scale_range=(0.9, 1.1), val_frac=0.34, val_bs=val_bs)
    jd, pd = _data(jdet, varied, **kw), _data(pdet, varied, **kw)
    assert pd.max_objects == jd.max_objects and pd.categories == jd.categories
    assert pd.cat2dscat == jd.cat2dscat
    for a, b in ((pd.train_ds, jd.train_ds), (pd.val_ds, jd.val_ds)):
        assert [im["id"] for im in a.images] == [im["id"] for im in b.images]
        for x, y in zip(a.images, b.images):
            assert (x["scale"], x["aspect_ratio"]) == (y["scale"],
                                                       y["aspect_ratio"])
            for (bx, cx), (by, cy) in zip(x["target"], y["target"]):
                np.testing.assert_array_equal(bx, by)
                assert cx == cy
    assert pd.train_dl.groups == jd.train_dl.groups
    assert pd.val_dl.groups == jd.val_dl.groups and pd.val_dl.bs == jd.val_dl.bs
    _same_batch(pd.train_dl.peek(), jd.train_dl.peek())
    for dls in [(pd.train_dl, jd.train_dl)] * 2 + [(pd.val_dl, jd.val_dl)]:
        # whole epochs (the second train epoch reshuffles)
        got, want = list(dls[0]), list(dls[1])
        assert len(got) == len(want) == len(dls[0])
        for a, b in zip(got, want):
            _same_batch(a, b)


# ------------------------------------------------------------- the Learner


@pytest.fixture(scope="module")
def jax_learner(uniform):
    data = _data(jdet, uniform)
    model = jdet.ObjectDetectionNet(num_classes=2, backbone="resnet18",
                                    feature_size=16)
    jl = jdet.ObjectDetectionLearner(tempfile.mkdtemp(), data, model, "Adam2",
                                     mesh=get_mesh(1), compute_dtype=None)
    params = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                    jl.params)
    rng = np.random.default_rng(11)
    for sub in ("regressor", "classifier"):
        for k in ("kernel", "bias"):
            leaf = params[sub]["output"][k]
            std = 1e-3 if k == "kernel" else 1.0
            params[sub]["output"][k] = rng.normal(0, std, leaf.shape).astype(
                np.float32)
    state = jax.tree_util.tree_map(lambda a: np.array(a, copy=True),
                                   jl.state)
    batches = [data.train_dl._make_batch(g, np.random.default_rng(j))
               for j, g in enumerate(data.train_dl.groups[:2])]
    return jl, params, state, batches


def _fresh(jax_learner, root, **data_kw):
    """The JAX Learner at the starting weights, unfrozen, and a port
    Learner (its own data object over the same files) on them."""
    jl, params, state, batches = jax_learner
    jl.params = pmesh.shard_params(params, jl.mesh, jl.param_sharding)
    jl.state = pmesh.replicate_tree(state, jl.mesh)
    jl.unfreeze()
    model = pdet.ObjectDetectionNet(2, backbone="resnet18", feature_size=16,
                                    device="cpu")
    load_jax_params(model, params, batch_stats=state["batch_stats"])
    pl = pdet.ObjectDetectionLearner(tempfile.mkdtemp(),
                                     _data(pdet, root, **data_kw), model,
                                     "Adam2", compute_dtype=None,
                                     device="cpu")
    return jl, pl, batches


@pytest.mark.parametrize("frozen", [False, True])
def test_loss_trajectory_matches_jax(jax_learner, uniform, frozen):
    """Three Adam2 steps (wd 1e-4, clip 1.0) on batches 0, 1, 0; frozen,
    only the subnets move (body and FPN bit for bit)."""
    jl, pl, batches = _fresh(jax_learner, uniform)
    for lr_ in (jl, pl):
        if frozen:
            lr_.freeze()
        lr_.init_optimizer(wd=1e-4, clip=1.0)
    before = {n: p.detach().clone() for n, p in pl.model.named_parameters()}
    want = [float(jl.train1minibatch(batches[i], LR)) for i in (0, 1, 0)]
    got = [float(pl.train1minibatch(batches[i], LR)) for i in (0, 1, 0)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    moved = {n for n, p in pl.model.named_parameters()
             if not torch.equal(p, before[n])}
    if frozen:
        assert moved and all(n.startswith(("regressor", "classifier"))
                             for n in moved)
    else:
        assert any(n.startswith("body") for n in moved)


def test_evaluate_matches_jax(jax_learner, uniform):
    jl, pl, _ = _fresh(jax_learner, uniform)
    metrics = lambda mod, lf: [mod.SSD_RegLoss(lf), mod.SSD_ClasLoss(lf),
                               mod.ComputeMaxOverlaps()]
    want = jl.evaluate("val", metrics(jdet, jl.loss_func))
    got = pl.evaluate("val", metrics(pdet, pl.loss_func))
    assert len(got) == len(want) == 2       # [loss, metrics]: no accuracy
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    with pytest.raises(ValueError, match="end metrics"):
        pl.evaluate("val", ["auc"])


def _same_preds(got, want):
    assert len(got[0]) == len(want[0])
    for gb, gc, gs, wb, wc, ws in zip(*got, *want):
        assert gc == wc
        np.testing.assert_allclose(gs, ws, rtol=1e-5)
        if len(gb):
            np.testing.assert_allclose(np.stack(gb), np.stack(wb), atol=1e-3)


def test_predict_map_coco_tta_match_jax(jax_learner, uniform):
    jl, pl, _ = _fresh(jax_learner, uniform)
    kw = dict(thresh=0.05, max_boxes=5)
    want = jl.predict("val", **kw)
    got = pl.predict("val", **kw)
    _same_preds(got, want)
    assert sum(len(s) for s in got[2]) > 0
    preds = list(zip(*got))
    for th in ([0.5], None):
        a = {} if th is None else {"thresholds": th}
        np.testing.assert_allclose(pl.compute_mAP(preds, **a),
                                   jl.compute_mAP(list(zip(*want)), **a),
                                   atol=1e-6)
    np.testing.assert_allclose(
        pl.coco_pascal_eval(str(uniform / "train.json"), preds),
        jl.coco_pascal_eval(str(uniform / "train.json"), list(zip(*want))),
        atol=1e-6)
    t_want = jl.TTA_bbox("val", num_augs=1, **kw)
    t_got = pl.TTA_bbox("val", num_augs=1, **kw)
    _same_preds(list(zip(*t_got)), list(zip(*t_want)))


# ------------------------------------------------------- the device cache


def test_photometric_matches_jax_formula():
    """The cache pipeline's jitter against the JAX host transform's, with
    the factors it drew passed in."""
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    tfm = jdet.TransformBBox("Basic", jitter=0)
    tfm.seed(5)
    want = tfm(img, 0)[0]
    draw = np.random.default_rng(5)
    bal = draw.uniform(*tfm.bal_range)
    cont = draw.uniform(*tfm.cont_range)
    got = pdet.photometric(torch.from_numpy(img)[None],
                           torch.tensor(bal, dtype=torch.float32),
                           torch.tensor(cont, dtype=torch.float32))[0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_cached_pipeline_and_step_match_jax(jax_learner, uniform):
    """enable_device_cache without photometric jitter: the canvas bit for
    bit, the cached pipeline on given flip rows, and a cached train step's
    loss, against JAX's."""
    jl, params, state, _ = jax_learner
    jd = _data(jdet, uniform, photo=False)
    jl2 = jdet.ObjectDetectionLearner(tempfile.mkdtemp(), jd, jl.model,
                                      "Adam2", mesh=get_mesh(1),
                                      compute_dtype=None)
    jl2.params = pmesh.shard_params(params, jl2.mesh, jl2.param_sharding)
    jl2.state = pmesh.replicate_tree(state, jl2.mesh)
    jl2.enable_device_cache(include_val=True)
    _, pl, _ = _fresh(jax_learner, uniform, photo=False)
    pl.enable_device_cache(include_val=True)
    np.testing.assert_array_equal(pl._det_cache.numpy(),
                                  np.asarray(jl2._det_cache))
    rows = np.asarray([0, 5, 2, 7], np.int32)
    flip = np.asarray([1, 0, 1, 0], np.int32)
    for train in (False, True):
        want = jl2.input_pipeline(jax.random.PRNGKey(0), (rows, flip),
                                  train)[0]
        got = pl.input_pipeline(pl.pipeline_generator,
                                (torch.from_numpy(rows),
                                 torch.from_numpy(flip)), train)[0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    b = pl.data.train_dl.peek()
    bj = jd.train_dl.peek()
    for x, y in zip(b.xs + b.y, bj.xs + bj.y):
        np.testing.assert_array_equal(x, y)
    jl2.init_optimizer(wd=1e-4, clip=1.0)
    pl.init_optimizer(wd=1e-4, clip=1.0)
    np.testing.assert_allclose(float(pl.train1minibatch(b, LR)),
                               float(jl2.train1minibatch(bj, LR)), rtol=1e-4)


def test_cached_predict_matches_host(jax_learner, uniform):
    """Cached predict (gather, forward, decode, NMS on the device) equals
    the host path when the framing matches (images of one size); cached
    training steps run, and cached TTA gives per-image lists."""
    _, pl, _ = _fresh(jax_learner, uniform)
    host = pl.predict("val", thresh=0.05, max_boxes=5)
    pl.enable_device_cache(include_val=True)
    assert isinstance(pl.data.val_dl, pdet.CachedBBoxLoader)
    cached = pl.predict("val", thresh=0.05, max_boxes=5)
    _same_preds(cached, host)
    pl.init_optimizer(wd=1e-4, clip=1.0)
    losses = [float(pl.train1minibatch(b, LR)) for b in pl.data.train_dl]
    assert np.isfinite(losses).all()
    assert np.isfinite(pl.evaluate("val")[0])
    tta = pl.TTA_bbox("val", num_augs=2, thresh=0.05, max_boxes=5)
    assert len(tta) == len(pl.data.val_ds)
    for boxes, classes, scores in tta:
        assert len(boxes) == len(classes) == len(scores) <= 5
        assert scores == sorted(scores, reverse=True)
