"""The port's COCO evaluator (utils/cocoeval.py, its IoU and matching in
native/cocoeval.cpp) against the JAX package's on the CPU, and the C++
helpers against their numpy versions.

Ground truths and detections are drawn from numpy seeds over several
images and categories, with crowd, 'ignore' and out-of-range-area boxes,
tied scores and images without detections.  The 12 COCOeval stats and
the precision / recall arrays must equal the JAX package's exactly; the
C++ IoU equals the numpy IoU exactly (no fma: the library builds without
-march=native), and the JAX package's C++ IoU (built with it) to 1e-15
relative; the C++ matching equals the python loop exactly.
"""

import json

import numpy as np
import pytest

from neuralnetworklibrary_tpu.utils import cocoeval as jce
from neuralnetworklibrary_tpu_torch.utils import cocoeval as pce


def _dataset(seed, n_img=6, n_cat=3):
    rng = np.random.default_rng(seed)
    images = [{"id": 100 + i, "width": 200, "height": 150}
              for i in range(n_img)]
    cats = [{"id": 10 * (c + 1), "name": f"c{c}"} for c in range(n_cat)]
    anns, dets = [], []
    aid = 1
    for im in images:
        for _ in range(int(rng.integers(0, 6))):
            w, h = rng.uniform(4, 120, 2)
            x, y = rng.uniform(0, 80, 2)
            a = {"id": aid, "image_id": im["id"],
                 "category_id": cats[int(rng.integers(0, n_cat))]["id"],
                 "bbox": [float(x), float(y), float(w), float(h)],
                 "area": float(w * h),
                 "iscrowd": int(rng.random() < 0.1)}
            if rng.random() < 0.15:
                a["ignore"] = 1
            anns.append(a)
            aid += 1
            # detections: jittered copies, some with tied scores
            for _ in range(int(rng.integers(0, 3))):
                jit = rng.normal(0, 6, 4)
                dets.append({"image_id": im["id"],
                             "category_id": a["category_id"],
                             "bbox": [float(x + jit[0]), float(y + jit[1]),
                                      float(max(w + jit[2], 1)),
                                      float(max(h + jit[3], 1))],
                             "score": float(np.round(rng.random() * 5) / 5)})
        for _ in range(int(rng.integers(0, 3))):      # false positives
            x, y, w, h = rng.uniform(0, 100, 4) + [0, 0, 2, 2]
            dets.append({"image_id": im["id"],
                         "category_id": cats[int(rng.integers(0, n_cat))]["id"],
                         "bbox": [float(x), float(y), float(w), float(h)],
                         "score": float(rng.random())})
    return {"images": images, "categories": cats, "annotations": anns}, dets


def _run(mod, gt, dets, img_ids=None):
    G = mod.COCO(json.loads(json.dumps(gt)))
    D = G.loadRes(json.loads(json.dumps(dets)))
    E = mod.COCOeval(G, D, "bbox")
    if img_ids is not None:
        E.params.imgIds = img_ids
    E.evaluate()
    E.accumulate()
    E.summarize()
    return E


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cocoeval_stats_match_jax(seed, capsys):
    gt, dets = _dataset(seed)
    ids = None if seed % 2 else [im["id"] for im in gt["images"][:4]]
    want = _run(jce, gt, dets, ids)
    jout = capsys.readouterr().out
    got = _run(pce, gt, dets, ids)
    assert capsys.readouterr().out == jout
    np.testing.assert_array_equal(got.stats, want.stats)
    np.testing.assert_array_equal(got.eval["precision"],
                                  want.eval["precision"])
    np.testing.assert_array_equal(got.eval["recall"], want.eval["recall"])
    assert got.stats[0] > 0


def test_cocoeval_from_files_and_empty_results(tmp_path):
    gt, dets = _dataset(5)
    with open(tmp_path / "gt.json", "w") as f:
        json.dump(gt, f)
    with open(tmp_path / "dt.json", "w") as f:
        json.dump(dets[:3], f)
    for mod_dets in ([], str(tmp_path / "dt.json")):
        res = []
        for mod in (jce, pce):
            G = mod.COCO(str(tmp_path / "gt.json"))
            E = mod.COCOeval(G, G.loadRes(mod_dets), "bbox")
            E.evaluate()
            E.accumulate()
            res.append(E.summarize())
        np.testing.assert_array_equal(res[1], res[0])


@pytest.mark.parametrize("seed", range(4))
def test_native_helpers_match_numpy(seed):
    rng = np.random.default_rng(seed)
    D, G = int(rng.integers(0, 12)), int(rng.integers(0, 9))
    dets = np.concatenate([rng.uniform(0, 60, (D, 2)),
                           rng.uniform(0, 40, (D, 2))], 1)
    gts = np.concatenate([rng.uniform(0, 60, (G, 2)),
                          rng.uniform(0, 40, (G, 2))], 1)
    if G > 1:
        gts[0, 2] = 0.0                  # a zero-area gt
    crowd = rng.integers(0, 2, G)
    got = pce.bbox_iou_xywh(dets, gts, crowd)
    want = pce.iou_xywh_numpy(dets, gts, crowd)
    np.testing.assert_array_equal(got, want)
    # the JAX package builds its helper with -march=native: an fma there
    # may move the last bit
    np.testing.assert_allclose(got, jce.bbox_iou_xywh(dets, gts, crowd),
                               rtol=1e-15, atol=1e-17)
    ig = np.sort(rng.integers(0, 2, G))  # ignore-last order
    thrs = np.linspace(0.5, 0.95, 10)
    for g, w in zip(pce.match_greedy(got, ig, crowd, thrs),
                    pce.match_greedy_numpy(got, ig, crowd, thrs)):
        np.testing.assert_array_equal(g, w)


def test_native_library_is_built_in_the_port():
    from neuralnetworklibrary_tpu_torch.kernels import build

    lib = build.load("cocoeval")
    assert build.library_path("cocoeval").is_file()
    assert "neuralnetworklibrary_tpu_torch/_build" in str(
        build.library_path("cocoeval"))
    assert lib.iou_xywh is not None
