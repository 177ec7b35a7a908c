"""The port's SSD loss (anchor matching, focal loss, smooth-L1, ``ssd1``,
``SSD_loss``) and detection metrics (``SSD_RegLoss``, ``SSD_ClasLoss``,
``ComputeMaxOverlaps``) against the JAX package on the CPU.

Anchors are those of a 64 x 96 image (2,727 of them); objects, -1 padded
to M 4, are drawn near anchors from a numpy seed, and one image has no
object at all.  ``reg`` and ``clas`` are random.  Tolerances, float32:
matching exactly; each loss and metric within rtol 1e-5; the gradients
with respect to ``reg`` and ``clas`` (against ``jax.grad``) within 1e-5 x
max|JAX gradient|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import detection as jdet
from neuralnetworklibrary_tpu_torch.applications import detection as pdet
from neuralnetworklibrary_tpu_torch.nn.retinanet import generate_anchors

ANCHORS = generate_anchors((64, 96))
N, C, M, B = len(ANCHORS), 3, 4, 3


def _data(seed):
    rng = np.random.default_rng(seed)
    bb = np.full((B, M, 4), -1.0, np.float32)
    cc = np.full((B, M), -1, np.int32)
    for i, n in enumerate((3, 1, 0)):          # image 2 holds no object
        a = ANCHORS[rng.integers(0, N, n)]
        a = np.clip(a + rng.normal(0, 2, a.shape), 0, [96, 64, 96, 64])
        bb[i, :n] = a
        cc[i, :n] = rng.integers(0, C, n)
    reg = rng.normal(0, 1, (B, N, 4)).astype(np.float32)
    clas = rng.uniform(0.01, 0.99, (B, N, C)).astype(np.float32)
    mask = np.asarray([1, 1, 0], np.float32)
    return bb, cc, reg, clas, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got.detach() if torch.is_tensor(got)
                                          else got), np.asarray(want),
                               rtol=rtol, atol=1e-7)


def test_match_anchors_objects_matches_jax_with_duplicates():
    """Duplicated objects give equal IoUs: both take the first."""
    bb, _, _, _, _ = _data(0)
    objs = bb[0].copy()
    objs[3] = objs[0]                      # a duplicate of object 0
    for o in (objs, bb[1], bb[2]):
        want = jdet.match_anchors_objects(jnp.asarray(o), jnp.asarray(ANCHORS))
        got = pdet.match_anchors_objects(_t(o), _t(ANCHORS))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    got = pdet.match_anchors_objects(_t(objs), _t(ANCHORS))
    assert (got[2] != 3).all() and (got[2] == 0).any()
    # batched over images, as SSD_loss calls it
    got_b = pdet.match_anchors_objects(_t(bb), _t(ANCHORS))
    for i in range(B):
        want = jdet.match_anchors_objects(jnp.asarray(bb[i]),
                                          jnp.asarray(ANCHORS))
        np.testing.assert_array_equal(got_b[2][i].numpy(), np.asarray(want[2]))
    assert not got_b[0][2].any() and got_b[1][2].all()


def test_focal_and_smooth_l1_match_jax():
    rng = np.random.default_rng(1)
    pred = rng.uniform(0.0, 1.0, (50, C)).astype(np.float32)
    pred[0, 0], pred[1, 1] = 0.0, 1.0      # into the clip
    target = (rng.random((50, C)) < 0.1).astype(np.float32)
    well = (rng.random(50) < 0.8).astype(np.float32)
    for w in (None, well):
        _close(pdet.focal_loss_retina(_t(pred), _t(target),
                                      None if w is None else _t(w)),
               jdet.focal_loss_retina(jnp.asarray(pred), jnp.asarray(target),
                                      None if w is None else jnp.asarray(w)))
    anchs = ANCHORS[:50]
    tgt = anchs + rng.normal(0, 3, anchs.shape).astype(np.float32)
    tgt[3] = [-1, -1, -1, -1]              # a padding target
    shift = rng.normal(0, 1, (50, 4)).astype(np.float32)
    pos = (rng.random(50) < 0.3).astype(np.float32)
    for p in (None, pos, np.zeros(50, np.float32)):
        _close(pdet.smoothL1_loss_retina(_t(anchs), _t(shift), _t(tgt),
                                         None if p is None else _t(p)),
               jdet.smoothL1_loss_retina(jnp.asarray(anchs),
                                         jnp.asarray(shift), jnp.asarray(tgt),
                                         None if p is None else jnp.asarray(p)))


@pytest.mark.parametrize("seed", [0, 1])
def test_ssd1_and_ssd_loss_match_jax(seed):
    bb, cc, reg, clas, mask = _data(seed)
    for i in range(B):       # per image, the empty one included
        want = jdet.ssd1(jnp.asarray(ANCHORS), jnp.asarray(bb[i]),
                         jnp.asarray(cc[i]), jnp.asarray(reg[i]),
                         jnp.asarray(clas[i]))
        got = pdet.ssd1(_t(ANCHORS), _t(bb[i]), _t(cc[i]), _t(reg[i]),
                        _t(clas[i]))
        _close(got[0], want[0])
        _close(got[1], want[1])
    assert float(pdet.ssd1(_t(ANCHORS), _t(bb[2]), _t(cc[2]), _t(reg[2]),
                           _t(clas[2]))[0]) == 0.0
    activ_j = (jnp.asarray(ANCHORS), jnp.asarray(reg), jnp.asarray(clas))
    activ_p = (_t(ANCHORS), _t(reg), _t(clas))
    for beta in (0.5, 0.2):
        jl, pl = jdet.SSD_loss(beta), pdet.SSD_loss(beta)
        for m in (None, mask):
            _close(pl(activ_p, (_t(bb), _t(cc)), None if m is None else _t(m)),
                   jl(activ_j, (jnp.asarray(bb), jnp.asarray(cc)),
                      None if m is None else jnp.asarray(m)))


def test_metrics_match_jax():
    bb, cc, reg, clas, mask = _data(2)
    activ_j = (jnp.asarray(ANCHORS), jnp.asarray(reg), jnp.asarray(clas))
    activ_p = (_t(ANCHORS), _t(reg), _t(clas))
    jl, pl = jdet.SSD_loss(), pdet.SSD_loss()
    pairs = [(jdet.SSD_RegLoss(jl), pdet.SSD_RegLoss(pl)),
             (jdet.SSD_ClasLoss(jl), pdet.SSD_ClasLoss(pl)),
             (jdet.ComputeMaxOverlaps(), pdet.ComputeMaxOverlaps())]
    for jm, pm in pairs:
        for m in (None, mask):
            _close(pm(activ_p, (_t(bb), _t(cc)), None if m is None else _t(m)),
                   jm(activ_j, (jnp.asarray(bb), jnp.asarray(cc)),
                      None if m is None else jnp.asarray(m)))


def test_gradients_match_jax_grad():
    """d SSD_loss / d (reg, clas) with a mask and an empty image: finite,
    and equal to jax.grad's."""
    bb, cc, reg, clas, mask = _data(3)
    clas[0, 0, 0] = 0.99995                # inside the clip's flat part

    def jloss(r, c):
        return jdet.SSD_loss()((jnp.asarray(ANCHORS), r, c),
                               (jnp.asarray(bb), jnp.asarray(cc)),
                               jnp.asarray(mask))

    wr, wc = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(reg),
                                            jnp.asarray(clas))
    r, c = _t(reg).requires_grad_(), _t(clas).requires_grad_()
    pdet.SSD_loss()((_t(ANCHORS), r, c), (_t(bb), _t(cc)), _t(mask)).backward()
    for g, w in ((r.grad, wr), (c.grad, wc)):
        w = np.asarray(w)
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    assert np.abs(wr).max() > 0 and not r.grad[2].any()   # masked row
