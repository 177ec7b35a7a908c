"""Port of ops/augment.py against the JAX package on the CPU.

Every stage runs on the same explicit parameters in both packages: the
warp on the same (A, b); ``augment_batch`` of JAX on a key against the
port's ``apply_augment`` on the draws that key makes (the port draws its
parameters apart from the stages, ``draw_augment_params``, so the stages
can be given JAX's).
Tolerance 1e-5 absolute on images in [0, 1] (float32 arithmetic in
another order); normalization and the kernels exactly or to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.ops import augment as jaug
from neuralnetworklibrary_tpu_torch.ops import augment as aug

B, H, W, C = 3, 12, 10, 3


def _imgs(seed=0, shape=(B, H, W, C)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_stats_and_kernel_match_jax():
    for a, b in zip(aug.imagenet_stats + aug.alternate_stats,
                    jaug.imagenet_stats + jaug.alternate_stats):
        np.testing.assert_array_equal(a, b)
    for k, s in ((11, None), (5, 1.3), (7, 0.0)):
        np.testing.assert_array_equal(aug._gaussian_kernel1d(k, s),
                                      jaug._gaussian_kernel1d(k, s))


def test_reflect_index_matches_jax():
    idx = np.arange(-25, 26, dtype=np.int32)
    for size in (1, 4, 10):
        np.testing.assert_array_equal(
            aug._reflect_index(_t(idx).long(), size).numpy(),
            np.asarray(jaug._reflect_index(jnp.asarray(idx), size)))


@pytest.mark.parametrize("out_hw", [None, (7, 9), (15, 13)])
def test_warp_matches_jax(out_hw):
    """Rotations, zooms, shears and shifts that sample past every border
    (reflected), on the input grid, a smaller one and a larger one."""
    rng = np.random.default_rng(1)
    imgs = _imgs(1)
    A = (np.eye(2, dtype=np.float32)[None]
         + rng.normal(0, 0.4, (B, 2, 2)).astype(np.float32))
    b = rng.uniform(-14, 14, (B, 2)).astype(np.float32)
    got = aug.warp_affine_batch(_t(imgs), _t(A), _t(b), out_hw).numpy()
    want = np.asarray(jaug.warp_affine_batch(
        jnp.asarray(imgs), jnp.asarray(A), jnp.asarray(b), out_hw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_rot_zoom_and_dihedral_affines_match_jax():
    deg = np.array([-10.0, 0.0, 33.0], np.float32)
    zoom = np.array([1.0, 1.05, 1.3], np.float32)
    for got, want in zip(aug._rot_zoom_inverse(_t(deg), _t(zoom), 5, 6),
                         jaug._rot_zoom_inverse(jnp.asarray(deg),
                                                jnp.asarray(zoom), 5, 6)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    flip = np.array([0, 1, 1, 0], np.int32)
    rot = np.array([0, 1, 2, 3], np.int32)
    for got, want in zip(aug._dihedral_inverse(_t(flip), _t(rot), 8),
                         jaug._dihedral_inverse(jnp.asarray(flip),
                                                jnp.asarray(rot), 8)):
        np.testing.assert_array_equal(got.numpy(), want)
    # the dihedral affine through the warp is the flip-then-rot90 of JAX
    imgs = _imgs(2, (4, 8, 8, C))
    A, b = aug._dihedral_inverse(_t(flip), _t(rot), 8)
    warped = aug.warp_affine_batch(_t(imgs), A, b).numpy()
    for i in range(4):
        want = imgs[i, :, ::-1] if flip[i] else imgs[i]
        np.testing.assert_allclose(warped[i], np.rot90(want, rot[i]),
                                   atol=1e-6)
    A, b = aug._identity_affine(2)
    Ac, bc = aug._compose(A, b, A, b + 1)
    np.testing.assert_array_equal(Ac.numpy(), A.numpy())
    np.testing.assert_array_equal(bc.numpy(), np.ones((2, 2), np.float32))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("stats", ["imagenet", None])
def test_normalize_batch_matches_jax(dtype, stats):
    st = {"imagenet": aug.imagenet_stats, None: None}[stats]
    raw = np.random.default_rng(3).integers(0, 256, (B, H, W, C))
    imgs = raw.astype(np.uint8) if dtype == np.uint8 else (
        raw / 255.0).astype(np.float32)
    got = aug.normalize_batch(_t(imgs), st)
    want = np.asarray(jaug.normalize_batch(jnp.asarray(imgs), st))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _jax_draws(key, shape, tfm_type, max_deg, max_zoom, bal_range,
               cont_range, max_noise):
    """The draws ``_augment_impl`` makes from ``key`` (its own splits and
    distributions), as numpy arrays under the port's names."""
    Bn, Hn, Wn, Cn = shape
    k_rz, k_flip, k_rot, k_bal, k_cont, k_noise = jax.random.split(key, 6)
    p = {}
    if max_deg is not None:
        kd, kz = jax.random.split(k_rz)
        p["deg"] = jax.random.uniform(kd, (Bn,), minval=-max_deg,
                                      maxval=max_deg)
        p["zoom"] = jax.random.uniform(kz, (Bn,), minval=1.0,
                                       maxval=max_zoom)
    if tfm_type in ("SideOn", "TopDown"):
        p["flip"] = jax.random.randint(k_flip, (Bn,), 0, 2)
        if tfm_type == "TopDown":
            p["rot"] = jax.random.randint(k_rot, (Bn,), 0, 4)
    p["bal"] = jax.random.uniform(k_bal, (Bn, 1, 1, 1), minval=bal_range[0],
                                  maxval=bal_range[1])
    p["cont"] = jax.random.uniform(k_cont, (Bn, 1, 1, 1),
                                   minval=cont_range[0],
                                   maxval=cont_range[1])
    if max_noise:
        p["noise"] = jax.random.uniform(k_noise, shape, minval=-max_noise,
                                        maxval=max_noise)
    return {k: np.asarray(v) for k, v in p.items()}


@pytest.mark.parametrize("tfm_type,max_deg,max_noise", [
    ("SideOn", 10.0, None), ("TopDown", None, 0.1), ("Basic", 30.0, 0.05)])
def test_stages_match_jax_on_its_draws(tfm_type, max_deg, max_noise):
    """JAX's ``augment_batch(key, ...)`` against the port's
    ``apply_augment`` on the draws that key makes."""
    raw = np.random.default_rng(4).integers(0, 256, (4, 11, 11, C)).astype(
        np.uint8)
    kw = dict(tfm_type=tfm_type, max_deg=max_deg, max_zoom=1.2,
              bal_range=(-0.2, 0.2), cont_range=(0.7, 1.3),
              max_noise=max_noise)
    key = jax.random.PRNGKey(5)
    want = np.asarray(jaug.augment_batch(key, jnp.asarray(raw), **kw,
                                         stats=jaug.imagenet_stats))
    p = _jax_draws(key, raw.shape, **kw)
    assert set(p) == set(aug.draw_augment_params(
        torch.Generator(), _t(raw), **kw))
    got = aug.apply_augment(_t(raw), {k: _t(v) for k, v in p.items()},
                            aug.imagenet_stats).numpy()
    # 1e-5 on the [0, 1] image, over the smallest imagenet std
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 / 0.224)


def test_blur_matches_jax():
    noise = np.random.default_rng(6).uniform(-0.1, 0.1, (2, 9, 14, C)).astype(
        np.float32)
    k = aug._gaussian_kernel1d(11)
    np.testing.assert_allclose(
        aug._blur_separable(_t(noise), k).numpy(),
        np.asarray(jaug._blur_separable(jnp.asarray(noise), k)),
        rtol=0, atol=1e-6)


def test_draws_follow_the_jax_ranges():
    imgs = torch.zeros(4000, 2, 2, C, dtype=torch.uint8)
    p = aug.draw_augment_params(torch.Generator().manual_seed(0), imgs,
                                tfm_type="TopDown", max_deg=10,
                                max_zoom=1.05, bal_range=(-0.05, 0.05),
                                cont_range=None, max_noise=0.2)
    assert -10 <= float(p["deg"].min()) and float(p["deg"].max()) <= 10
    assert 1.0 <= float(p["zoom"].min()) and float(p["zoom"].max()) <= 1.05
    assert set(p["flip"].tolist()) == {0, 1}
    assert set(p["rot"].tolist()) == {0, 1, 2, 3}
    assert torch.all(p["cont"] == 1.0)
    assert p["bal"].shape == (4000, 1, 1, 1)
    assert float(p["noise"].abs().max()) <= 0.2
    assert "bal" not in aug.draw_augment_params(
        torch.Generator(), imgs[:2], bal_range=None)


def test_augment_batch_is_seeded_and_typed():
    imgs = _t(np.random.default_rng(7).integers(0, 256, (B, H, H, C))
              .astype(np.uint8))

    def run(seed):
        return aug.augment_batch(torch.Generator().manual_seed(seed), imgs,
                                 tfm_type="TopDown", max_deg=10,
                                 max_noise=0.1)

    a, b, c = run(0), run(0), run(1)
    assert a.dtype == torch.float32 and a.shape == (B, H, H, C)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert torch.isfinite(a).all()
    with pytest.raises(ValueError, match="square"):
        aug.augment_batch(torch.Generator(), imgs[:, :, :-1],
                          tfm_type="TopDown")
