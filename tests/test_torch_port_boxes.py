"""The port's box operations (ops/boxes.py) and detection's prediction
helpers (``_predict_device``, ``nms_post_passes``, ``mAP1``, ``mAP``)
against the JAX package on the CPU.

Inputs come from numpy seeds.  Tolerances, float32: IoU and decoded boxes
within 1e-6 absolute + 1e-5 relative; NMS (top-k by a stable sort and the
fixed-point sweep against ``lax.top_k`` and the ``fori_loop``) keeps the
same candidates in the same order: boxes within 1e-6, classes and scores
exactly, and the counts exactly; the host prune passes and the mAP are
numpy on both sides and must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import detection as jdet
from neuralnetworklibrary_tpu.ops import boxes as jboxes
from neuralnetworklibrary_tpu_torch.applications import detection as pdet
from neuralnetworklibrary_tpu_torch.ops import boxes


def _boxes(rng, shape, lo=0.0, hi=100.0, size=(2.0, 30.0)):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(*size, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_pairwise_iou_matches_jax_with_degenerate_boxes():
    rng = np.random.default_rng(0)
    a = _boxes(rng, (9,))
    b = _boxes(rng, (11,))
    a[0] = [5, 5, 5, 9]          # zero width
    a[1] = [-1, -1, -1, -1]      # the -1 padding row
    b[2] = [10, 10, 4, 4]        # inverted: negative extent
    b[3] = a[4]                  # identical: IoU 1
    want = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = boxes.pairwise_iou(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[0].max() == 0 and got[1].max() == 0 and got[:, 2].max() == 0
    assert got[4, 3] == pytest.approx(1.0)
    # batched over a leading dim, as the port's NMS and loss call it
    ab = np.stack([a, a[::-1]])
    got_b = boxes.pairwise_iou(_t(ab), _t(b)).numpy()
    np.testing.assert_allclose(got_b[1], got[::-1], rtol=0, atol=0)


def test_decode_boxes_matches_jax_with_clipping():
    rng = np.random.default_rng(1)
    anchors = _boxes(rng, (40,), lo=-20, hi=90, size=(4, 60))
    reg = rng.normal(0, 2.0, (3, 40, 4)).astype(np.float32)
    want = np.asarray(jboxes.decode_boxes(jnp.asarray(reg),
                                          jnp.asarray(anchors), (64, 96)))
    got = boxes.decode_boxes(_t(reg), _t(anchors), (64, 96)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[..., 0].min() == 0 and got[..., 2].max() == 96
    assert got[..., 1].min() == 0 and got[..., 3].max() == 64


def _nms_case(seed, N=60, n_classes=3, ties=True, pad=10):
    rng = np.random.default_rng(seed)
    # clustered boxes: many overlaps, so suppression chains form
    b = _boxes(rng, (N,), lo=0, hi=40, size=(10, 30))
    c = rng.integers(0, n_classes, N).astype(np.int32)
    s = rng.uniform(0.05, 1.0, N).astype(np.float32)
    if ties:
        # bf16-like scores: a handful of values, each many times
        s = np.round(s * 8) / 8 + 0.01
        s = s.astype(np.float32)
    s[N - pad:] = 0.0            # padded / below-threshold rows
    return b, c, s


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("top_k,out_k", [(1000, 20), (25, 8)])
def test_nms_fixed_matches_jax(seed, top_k, out_k):
    b, c, s = _nms_case(seed, ties=seed % 2 == 0)
    want = jboxes.nms_fixed(jnp.asarray(b), jnp.asarray(c), jnp.asarray(s),
                            max_overlap=0.5, top_k=top_k, out_k=out_k,
                            return_counts=True)
    got = boxes.nms_fixed(_t(b), _t(c).long(), _t(s), max_overlap=0.5,
                          top_k=top_k, out_k=out_k, return_counts=True)
    wb, wc, ws, wn = (np.asarray(x) for x in want)
    gb, gc, gs, gn = (x.numpy() for x in got)
    np.testing.assert_array_equal(gs, ws)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_allclose(gb, wb, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(gn, wn)


def test_nms_cascade_revival():
    """A kills B; B would kill C but is dead, so C lives (the greedy
    sweep, not a one-shot matrix suppression)."""
    b = np.asarray([[0, 0, 10, 10], [3, 0, 13, 10], [6, 0, 16, 10]],
                   np.float32)
    c = np.zeros(3, np.int64)
    s = np.asarray([0.9, 0.8, 0.7], np.float32)
    _, _, gs, counts = boxes.nms_fixed(_t(b), _t(c), _t(s), out_k=3,
                                       return_counts=True)
    np.testing.assert_allclose(gs.numpy(), [0.9, 0.7, 0.0])
    assert counts.tolist() == [3, 2]
    want = np.asarray(jboxes.nms_fixed(jnp.asarray(b), jnp.asarray(c),
                                       jnp.asarray(s), out_k=3)[2])
    np.testing.assert_array_equal(gs.numpy(), want)


def test_nms_long_chain_needs_many_sweeps():
    """A chain of 12 boxes, each overlapping the next: the greedy result
    alternates, and the fixed point takes the chain's depth in sweeps."""
    x = np.arange(12, dtype=np.float32) * 3
    b = np.stack([x, np.zeros(12), x + 10, np.full(12, 10)], 1)
    b = b.astype(np.float32)
    s = np.linspace(0.9, 0.3, 12).astype(np.float32)
    c = np.zeros(12, np.int64)
    got = boxes.nms_fixed(_t(b), _t(c), _t(s), out_k=12)[2].numpy()
    want = np.asarray(jboxes.nms_fixed(jnp.asarray(b), jnp.asarray(c),
                                       jnp.asarray(s), out_k=12)[2])
    np.testing.assert_array_equal(got, want)
    assert boxes.last_sweeps > 3


def test_batched_nms_matches_jax_rows():
    cases = [_nms_case(10 + i, N=50) for i in range(3)]
    b, c, s = (np.stack(x) for x in zip(*cases))
    s[1] = 0.0                   # a row with no candidate at all
    want = jboxes.batched_nms(jnp.asarray(b), jnp.asarray(c), jnp.asarray(s),
                              out_k=10)
    got = boxes.batched_nms(_t(b), _t(c).long(), _t(s), out_k=10)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    assert (got[2][1] == 0).all()


@pytest.mark.parametrize("thresh", [0.05, 0.3])
def test_predict_device_matches_jax(thresh):
    """Decode, threshold, class argmax and NMS of random activations,
    with tied scores across classes."""
    from neuralnetworklibrary_tpu_torch.nn.retinanet import generate_anchors

    rng = np.random.default_rng(3)
    anchors = generate_anchors((64, 96))
    N = len(anchors)
    reg = rng.normal(0, 1, (2, N, 4)).astype(np.float32)
    clas = rng.uniform(0, 1, (2, N, 3)).astype(np.float32)
    clas = (np.round(clas * 64) / 64).astype(np.float32)   # many ties
    want = jdet._predict_device(jnp.asarray(reg), jnp.asarray(clas),
                                jnp.asarray(anchors), (64, 96), thresh=thresh,
                                top_k=300, out_k=20, return_counts=True)
    got = pdet._predict_device(_t(reg), _t(clas), _t(anchors), (64, 96),
                               thresh=thresh, top_k=300, out_k=20,
                               return_counts=True)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("mode", ["none", "rel", "inc", "dup", "all"])
def test_nms_post_passes_matches_jax(mode, capsys):
    rng = np.random.default_rng(4)
    b = _boxes(rng, (30,), lo=0, hi=50, size=(5, 40))
    c = rng.integers(0, 3, 30)
    s = np.sort(rng.uniform(0.05, 1, 30))[::-1].astype(np.float32)
    kw = {"none": {}, "rel": {"rel_thresh": (0.3, 0.5)},
          "inc": {"inc": (0.8, [2])},
          "dup": {"dup": (0.5, {(0, 1), (1, 0), (1, 2)})},
          "all": {"rel_thresh": (0.2, 0.4), "inc": (0.7, []),
                  "dup": (0.4, {(0, 1), (2, 0)})}}[mode]
    want = jdet.nms_post_passes(b, c, s, max_boxes=12, print_it=True, **kw)
    jout = capsys.readouterr().out
    got = pdet.nms_post_passes(b, c, s, max_boxes=12, print_it=True, **kw)
    assert capsys.readouterr().out == jout
    assert got[1] == want[1] and got[2] == want[2]
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


def test_predictor_print_it_matches_jax(capsys):
    from neuralnetworklibrary_tpu_torch.nn.retinanet import generate_anchors

    rng = np.random.default_rng(5)
    anchors = generate_anchors((32, 32))
    N = len(anchors)
    reg = rng.normal(0, 1, (2, N, 4)).astype(np.float32)
    clas = rng.uniform(0, 0.4, (2, N, 2)).astype(np.float32)
    want = jdet.BBoxPredictor()((32, 32), jnp.asarray(reg), jnp.asarray(clas),
                                jnp.asarray(anchors), rel_thresh=(0.5, 0.5),
                                print_it=True)
    jout = capsys.readouterr().out
    got = pdet.BBoxPredictor()((32, 32), _t(reg), _t(clas), _t(anchors),
                               rel_thresh=(0.5, 0.5), print_it=True)
    assert capsys.readouterr().out == jout
    assert got[1] == want[1]
    np.testing.assert_allclose(np.asarray(sum(got[2], [])),
                               np.asarray(sum(want[2], [])), rtol=1e-6)


def test_mAP_matches_jax():
    rng = np.random.default_rng(6)
    n_img, C = 7, 3
    targets, predictions = [], []
    for i in range(n_img):
        t = _boxes(rng, (int(rng.integers(0, 4)),), size=(8, 30))
        targets.append([(bb, int(rng.integers(0, C))) for bb in t])
        # predictions near the targets plus false positives, tied scores
        near = t + rng.normal(0, 3, t.shape).astype(np.float32)
        p = np.concatenate([near, _boxes(rng, (2,))])
        predictions.append([list(p), [int(x) for x in rng.integers(0, C,
                                                                   len(p))],
                            [float(x) for x in np.round(rng.uniform(
                                0, 1, len(p)) * 4) / 4]])
    cats = {i: str(i) for i in range(C)}
    for th in ([0.5], [0.3, 0.5, 0.75]):
        assert pdet.mAP(predictions, targets, cats, th) == jdet.mAP(
            predictions, targets, cats, th)
    t = [[np.asarray([0, 0, 10, 10], np.float32)], []]
    p = [[np.asarray([0, 0, 10, 10], np.float32)],
         [np.asarray([5, 5, 20, 20], np.float32)]]
    assert pdet.mAP1(t, p, [[0.6], [0.9]], 0.5) == pytest.approx(0.5)
