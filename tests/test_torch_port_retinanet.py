"""The port's RetinaNet parts (nn/retinanet.py, nn/resnet.py's
``return_pyramid``, applications/detection.py's ObjectDetectionNet and
``retinanet_coco_weights``) against the JAX package on the CPU.

The JAX ``init`` variables go into the port's modules by
``load_jax_params``; the subnets' output convs, zero at init, are filled
with random values first, so that ``reg`` and ``clas`` depend on every
weight and on the anchor-major row order.  Images and features are NHWC
numpy arrays from a seed.  Tolerances, float32: anchors equal; every
output within 1e-4 x max|JAX output| (eval and train mode); BatchNorm
running statistics within 1e-5 absolute + 1e-4 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import detection as jdet
from neuralnetworklibrary_tpu.nn import resnet as jresnet
from neuralnetworklibrary_tpu.nn import retinanet as jret
from neuralnetworklibrary_tpu.utils.torch_convert import load_torch_retinanet
from neuralnetworklibrary_tpu_torch.applications import detection as pdet
from neuralnetworklibrary_tpu_torch.nn import resnet, retinanet
from neuralnetworklibrary_tpu_torch.utils.jax_params import load_jax_params

TOL = 1e-4
B, H, W = 2, 64, 96


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-6))


def _random_outputs(outputs, seed):
    """Fill the given output convs' kernels and biases, in place."""
    rng = np.random.default_rng(seed)
    for out in outputs:
        for k in ("kernel", "bias"):
            out[k] = rng.normal(0, 0.02, out[k].shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 96), (100, 60), (375, 500),
                                   (512, 768)])
def test_anchors_equal_jax(shape):
    np.testing.assert_array_equal(retinanet.generate_anchors(shape),
                                  jret.generate_anchors(shape))
    assert retinanet.num_anchors_for(shape) == jret.num_anchors_for(shape)
    np.testing.assert_array_equal(
        retinanet.get_anchor_set((0.5, 1.0), (1.0, 1.5)),
        jret.get_anchor_set((0.5, 1.0), (1.0, 1.5)))


def test_anchors_of_the_bench_shape():
    """bench_detection's canvas: 375 x 500 at ARS (512, 1024), padded to
    granularity 128."""
    from neuralnetworklibrary_tpu_torch.applications.vision import (
        get_AspectRatioScale,
    )

    _, s = get_AspectRatioScale(375, 500, 512, 1024)
    hw = [pdet._snap_up(int(d * s), 128) for d in (375, 500)]
    assert hw == [512, 768]
    assert retinanet.num_anchors_for(hw) == 73656


def test_return_pyramid_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (B, 64, 96, 3)).astype(np.float32)
    jm = jresnet.resnet18(return_pyramid=True)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm = resnet.resnet18(return_pyramid=True, device="cpu")
    load_jax_params(pm, v["params"], batch_stats=v["batch_stats"])
    for arch in ("resnet18", "resnet50", "resnet152"):
        assert (getattr(resnet, arch)(device="meta").pyramid_channels
                == getattr(jresnet, arch)().pyramid_channels)
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    got = pm(_nchw(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape[1] == w.shape[3]
        _close(g.permute(0, 2, 3, 1), w)


def test_fpn_matches_jax_at_odd_sizes():
    """C4 and C3 of odd size: the upsampled P5 and P4 overshoot by one and
    are cropped."""
    rng = np.random.default_rng(1)
    c3 = rng.normal(0, 1, (B, 9, 13, 8)).astype(np.float32)
    c4 = rng.normal(0, 1, (B, 5, 7, 12)).astype(np.float32)
    c5 = rng.normal(0, 1, (B, 3, 4, 20)).astype(np.float32)
    jm = jret.FPN(16)
    v = _np(jm.init(jax.random.PRNGKey(0), c3, c4, c5))
    pm = retinanet.FPN((8, 12, 20), 16, device="cpu")
    load_jax_params(pm, v["params"])
    want = jm.apply(v, c3, c4, c5)
    got = pm(_nchw(c3), _nchw(c4), _nchw(c5))
    assert [tuple(g.shape[2:]) for g in got] == [
        (9, 13), (5, 7), (3, 4), (2, 2), (1, 1)]
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w)


SUBNETS = {"plain": dict(use_bn=False, drop=None),
           "bn": dict(use_bn=True, drop=None),
           "bn_drop": dict(use_bn=True, drop=(0.1, 0.2))}


@pytest.mark.parametrize("cfg", list(SUBNETS))
@pytest.mark.parametrize("kind", ["reg", "clas"])
def test_box_subnet_matches_jax(cfg, kind):
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (B, 5, 7, 16)).astype(np.float32)
    kw = dict(num_anchors=9, feature_size=16, **SUBNETS[cfg])
    if kind == "reg":
        kw.update(out_per_anchor=4)
    else:
        kw.update(out_per_anchor=3, prior=0.01, sigmoid_out=True)
    jm = jret.BoxSubNet(**kw)
    v = _np(jm.init(jax.random.PRNGKey(0), x))
    assert not np.abs(v["params"]["output"]["kernel"]).any()
    _random_outputs([v["params"]["output"]], 3)
    pm = retinanet.BoxSubNet(**kw, device="cpu")
    load_jax_params(pm, v["params"], batch_stats=v.get("batch_stats"))
    want = jm.apply(v, x, train=False)
    got = pm(_nchw(x), train=False)
    assert got.shape == (B, 5 * 7 * 9, kw["out_per_anchor"])
    _close(got, want)
    if SUBNETS[cfg]["use_bn"] and not SUBNETS[cfg]["drop"]:
        # train mode: batch statistics, flax momentum 0.01 (bn_train off
        # keeps the running ones)
        want, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
        got = pm(_nchw(x), train=True)
        _close(got, want)
        for i in range(5):
            for k, buf in (("mean", "running_mean"), ("var", "running_var")):
                np.testing.assert_allclose(
                    getattr(getattr(pm, f"bn{i}"), buf).numpy(),
                    np.asarray(upd["batch_stats"][f"bn{i}"][k]),
                    rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_net():
    """The JAX ObjectDetectionNet (resnet18, feature 16, 3 classes) with
    random output convs, and its variables as numpy."""
    jm = jdet.ObjectDetectionNet(num_classes=3, backbone="resnet18",
                                 feature_size=16)
    x = np.zeros((B, H, W, 3), np.float32)
    v = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    _random_outputs([v["params"][s]["output"]
                     for s in ("regressor", "classifier")], 4)
    return jm, v


def _port_net(v):
    pm = pdet.ObjectDetectionNet(3, backbone="resnet18", feature_size=16,
                                 device="cpu")
    return load_jax_params(pm, v["params"], batch_stats=v["batch_stats"])


@pytest.mark.parametrize("mode", ["eval", "train", "train_bn_frozen"])
def test_object_detection_net_matches_jax(mode):
    jm, v = _jax_net()
    pm = _port_net(v)
    x = np.random.default_rng(5).normal(0, 1, (B, H, W, 3)).astype(np.float32)
    kw = {"eval": dict(train=False), "train": dict(train=True),
          "train_bn_frozen": dict(train=True, bn_frozen="non_head")}[mode]
    if mode == "eval":
        want = jax.jit(jm.apply)(v, jnp.asarray(x))
    else:
        want, _ = jax.jit(functools.partial(jm.apply, mutable=["batch_stats"],
                                            **kw))(v, jnp.asarray(x))
    got = pm(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[1].shape == want[1].shape == (B, got[0].shape[0], 4)
    assert got[2].shape == want[2].shape == (B, got[0].shape[0], 3)
    _close(got[1], want[1])
    _close(got[2], want[2])
    # the classifier is not at its prior: the random output conv reaches it
    assert float(got[2].detach().std()) > 1e-3


def _torch_names(pm):
    """The reference's torch state-dict name of each port tensor (the
    inverse of detection's renaming)."""
    out = {}
    for name in pm.state_dict():
        if name.endswith("num_batches_tracked"):
            continue
        p = name.split(".")
        if p[0] == "body" and p[1] == "stem":
            t = ("conv1" if p[2] == "conv" else "bn1") + "." + p[3]
        elif p[0] == "body":
            layer, i = p[1].split("_")
            if p[2] == "down":
                t = f"{layer}.{i}.downsample.{0 if p[3] == 'conv' else 1}"
            else:
                t = f"{layer}.{i}.{p[3]}{p[2][1]}"
            t += "." + p[4]
        else:
            t = {"regressor": "regressionModel",
                 "classifier": "classificationModel"}.get(p[0], p[0])
            t = ".".join([t] + p[1:])
        out[name] = t
    return out


def test_retinanet_coco_weights_matches_jax_converter():
    """A random state dict in the reference's names, loaded by the port's
    renaming and by the JAX converter (load_torch_retinanet) carried over
    by load_jax_params: the same tensors, every one filled."""
    pm = pdet.retinanet18(3, feature_size=16, device="cpu")
    rng = np.random.default_rng(6)
    sd = {t: torch.from_numpy(rng.normal(0, 1, tuple(
        pm.state_dict()[n].shape)).astype(np.float32))
        for n, t in _torch_names(pm).items()}
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.1
    sd["fc.weight"] = torch.zeros(3, 3)          # no place in the model
    got = pdet.retinanet_coco_weights(sd, model=pm)
    params, stats = load_torch_retinanet(sd, layers=(2, 2, 2, 2),
                                         bottleneck=False,
                                         include_subnets=True)
    ref = load_jax_params(pdet.retinanet18(3, feature_size=16, device="cpu"),
                          params, batch_stats=stats)
    want = ref.state_dict()
    for name, t in got.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            torch.testing.assert_close(t, want[name], rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not fill"):
        pdet.retinanet_coco_weights({k: v for k, v in sd.items()
                                     if not k.startswith("fpn.P6")},
                                    model=pm)
