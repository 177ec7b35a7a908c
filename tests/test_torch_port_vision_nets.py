"""Port of the vision nets (nn/layers.py, nn/resnet.py, nn/senet.py and
applications/vision.py's ImageClassificationNet), each against the JAX
package on the CPU.

The same flax variables (params and batch_stats, from the JAX ``init``)
go into the port's modules by ``load_jax_params``; images are NHWC numpy
arrays from a seed, handed to the port's conv bodies as their NCHW view.
Tolerances, in float32: the forward in train and in eval mode within
1e-4 x max|JAX output|; the gradients of sum(out * w), in float64 (see
``test_gradients_match_jax``), within 1e-3 x max|JAX gradient| of each
leaf; the BatchNorm running statistics after
two train-mode forwards (flax momentum 0.9, biased variance) within 1e-5
absolute + 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications import vision as jvision
from neuralnetworklibrary_tpu.nn import layers as jlayers
from neuralnetworklibrary_tpu.nn import resnet as jresnet
from neuralnetworklibrary_tpu.nn import senet as jsenet
from neuralnetworklibrary_tpu_torch.applications import vision
from neuralnetworklibrary_tpu_torch.nn import layers, resnet, senet
from neuralnetworklibrary_tpu_torch.utils.jax_params import (
    _flatten,
    _torch_name,
    load_jax_params,
)

B = 4
SE_CFG = dict(kind="seresnext", layers=(1, 1, 1, 1), groups=4,
              reduction=16, inplanes=16, input_3x3=True, down_kernel=1,
              down_pad=0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_layout(name, arr):
    """A flax leaf in the port's layout (see utils.jax_params)."""
    if name.endswith(".kernel") and arr.ndim == 2:
        return arr.T
    if name.endswith(".kernel") and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


class Case:
    """One JAX module and the port's, with the JAX variables (``init`` on
    ``x``, or the given ``variables``) loaded into the port; ``nchw`` says
    whether the port module takes NCHW."""

    def __init__(self, jmod, pmod, x, nchw, variables=None):
        self.jmod, self.pmod, self.nchw = jmod, pmod, nchw
        self.vars = variables or _np(jax.jit(jmod.init)(
            jax.random.PRNGKey(0), jnp.asarray(x)))
        load_jax_params(pmod, self.vars["params"],
                        batch_stats=self.vars.get("batch_stats"))

    def port_in(self, x):
        t = torch.from_numpy(x)
        return t.permute(0, 3, 1, 2) if self.nchw else t

    def port_out(self, y):
        y = y.detach()
        return (y.permute(0, 2, 3, 1) if self.nchw and y.ndim == 4
                else y).numpy()

    @functools.cached_property
    def apply_train(self):
        return jax.jit(lambda v, x: self.jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))

    @functools.cached_property
    def apply_eval(self):
        return jax.jit(lambda v, x: self.jmod.apply(v, x, train=False))


def _resnet18():
    return jresnet.resnet18(), resnet.resnet18(device="cpu")


def _bottleneck():
    return (jresnet.ResNet(block=jresnet.Bottleneck, layers=(1, 1, 1, 1)),
            resnet.ResNet(resnet.Bottleneck, (1, 1, 1, 1), device="cpu"))


def _senet():
    return jsenet.SENet(**SE_CFG), senet.SENet(**SE_CFG, device="cpu")


NETS = {"resnet18": _resnet18, "bottleneck_1111": _bottleneck,
        "se_resnext_g4_3x3": _senet}
PIXELS = {"resnet18": (32, 33), "bottleneck_1111": (32, 33),
          "se_resnext_g4_3x3": (33,)}
_CASES: dict = {}


def _case(name, px):
    """One Case per (net, size), shared by the tests of this file (each
    JAX compile costs seconds on the CPU); the sizes of a net share one
    set of variables (a conv net's do not depend on the image size)."""
    key = (name, px)
    if key not in _CASES:
        torch.manual_seed(0)
        jm, pm = NETS[name]()
        x = np.random.default_rng(px).standard_normal(
            (B, px, px, 3)).astype(np.float32)
        first = _CASES.get((name, PIXELS[name][0]))
        _CASES[key] = (Case(jm, pm, x, nchw=True,
                            variables=first and first[0].vars), x)
    return _CASES[key]


NET_CASES = [(n, px) for n in NETS for px in PIXELS[n]]


def _close(got, want, rel):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("name,px", NET_CASES)
def test_forward_eval_matches_jax(name, px):
    case, x = _case(name, px)
    want = case.apply_eval(case.vars, jnp.asarray(x))
    got = case.port_out(case.pmod(case.port_in(x), train=False))
    assert got.shape == np.asarray(want).shape
    _close(got, want, 1e-4)


@pytest.mark.parametrize("name,px", NET_CASES)
def test_forward_train_and_stats_match_jax(name, px):
    """Two train-mode forwards on two batches: the outputs, then every
    BatchNorm's running mean and (biased) variance."""
    case, x = _case(name, px)
    x2 = np.random.default_rng(px + 100).standard_normal(x.shape).astype(
        np.float32)
    pm = case.pmod
    load_jax_params(pm, case.vars["params"],
                    batch_stats=case.vars["batch_stats"])
    v = case.vars
    for xb in (x, x2):
        want, mut = case.apply_train(v, jnp.asarray(xb))
        v = {**v, "batch_stats": _np(mut["batch_stats"])}
        got = case.port_out(pm(case.port_in(xb), train=True))
        _close(got, want, 1e-4)
    bufs = dict(pm.named_buffers())
    n = 0
    for name_, arr in _flatten(v["batch_stats"]):
        head, _, leaf = name_.rpartition(".")
        buf = bufs[f"{head}.running_{leaf}"].numpy()
        np.testing.assert_allclose(buf, arr, rtol=1e-5, atol=1e-5)
        n += 1
    assert n == 2 * sum(isinstance(m, layers.BatchNorm)
                        for m in pm.modules())
    # leave the shared case as it was loaded
    load_jax_params(pm, case.vars["params"],
                    batch_stats=case.vars["batch_stats"])


@pytest.mark.parametrize("name,px", [(n, PIXELS[n][-1]) for n in NETS])
def test_gradients_match_jax(name, px):
    """d sum(out * w) / d params in train mode (batch statistics), both
    packages in float64: through the train-mode BatchNorms of these tiny
    maps (B 4, a 2x2 last stage) float32 gradients lose up to ~6e-2 of
    max|grad| against float64 in the JAX package and in the port alike
    (resnet18 at 33 px), so float32 cannot tell the two apart."""
    case, x = _case(name, px)
    f64 = functools.partial(jax.tree_util.tree_map,
                            lambda a: np.asarray(a, np.float64))
    with jax.enable_x64(True):
        stats = f64(case.vars["batch_stats"])
        x64 = jnp.asarray(x.astype(np.float64))
        out = case.apply_eval(case.vars, jnp.asarray(x))
        w = np.random.default_rng(7).standard_normal(
            np.asarray(out).shape)

        def loss(params):
            y, _ = case.jmod.apply({"params": params, "batch_stats": stats},
                                   x64, train=True, mutable=["batch_stats"])
            return jnp.sum(y * w)

        want = _np(jax.jit(jax.grad(loss))(f64(case.vars["params"])))
    pm = case.pmod.double()
    pm.zero_grad(set_to_none=True)
    y = pm(case.port_in(x.astype(np.float64)), train=True)
    wt = torch.from_numpy(w)
    (y * (wt.permute(0, 3, 1, 2) if y.ndim == 4 else wt)).sum().backward()
    grads = {n: p.grad for n, p in pm.named_parameters()}
    for name_, g in _flatten(want):
        got = grads[_torch_name(name_)].numpy()
        assert got.dtype == np.float64
        _close(got, _port_layout(name_, g), 1e-3)
    pm.float()
    pm.zero_grad(set_to_none=True)
    load_jax_params(pm, case.vars["params"],
                    batch_stats=case.vars["batch_stats"])


@pytest.mark.parametrize("pre_bn", [True, False])
def test_fully_connected_net_matches_jax(pre_bn):
    sizes, x = (8, 6, 5, 4), np.random.default_rng(3).standard_normal(
        (4, 8)).astype(np.float32)
    jm = jlayers.FullyConnectedNet(sizes, (0.0, 0.0, 0.0), pre_bn=pre_bn)
    pm = layers.FullyConnectedNet(sizes, (0.0, 0.0, 0.0), pre_bn=pre_bn)
    case = Case(jm, pm, x, nchw=False)
    for train in (False, True):
        if train:
            want, mut = case.apply_train(case.vars, jnp.asarray(x))
        else:
            want = case.apply_eval(case.vars, jnp.asarray(x))
        got = case.port_out(pm(torch.from_numpy(x), train=train))
        _close(got, want, 1e-4)
    stats = dict(_flatten(_np(mut["batch_stats"])))
    np.testing.assert_allclose(pm.lins_0.bn.running_var.numpy(),
                               stats["lins_0.bn.var"], rtol=1e-5, atol=1e-5)


def test_adaptive_concat_pool_is_max_then_mean():
    x = np.random.default_rng(4).standard_normal((2, 5, 3, 6)).astype(
        np.float32)
    got = layers.adaptive_concat_pool2d(torch.from_numpy(x).permute(
        0, 3, 1, 2)).numpy()
    want = np.asarray(jlayers.adaptive_concat_pool2d(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_image_classification_net_matches_jax():
    """A ResNet body (BasicBlock, one block a stage) + the concat-pool
    head at 32 px, in eval, train, and train with bn_frozen 'non_head'
    (the body on its running statistics)."""
    data = type("D", (), {"categories": {i: str(i) for i in range(5)}})()
    split = jresnet.resnet_split_prefixes((1, 1, 1, 1))
    jm = jvision.ImageClassificationNet.create(
        data, (jresnet.ResNet(block=jresnet.BasicBlock, layers=(1, 1, 1, 1)),
               512, split), head=([16], (0.0, 0.0)))
    torch.manual_seed(0)
    pm = vision.ImageClassificationNet.create(
        data, (resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1), device="cpu"),
               512, split), head=([16], (0.0, 0.0)), device="cpu")
    x = np.random.default_rng(5).standard_normal((B, 32, 32, 3)).astype(
        np.float32)
    case = Case(jm, pm, x, nchw=False)
    assert pm.layer_group_prefixes == tuple(
        tuple(p.replace("/", ".") for p in g)
        for g in jm.layer_group_prefixes)
    for train, bn_frozen in ((False, None), (True, None),
                             (True, "non_head")):
        want = jax.jit(lambda v, xx: jm.apply(
            v, xx, train=train, bn_frozen=bn_frozen,
            mutable=["batch_stats"])[0])(case.vars, jnp.asarray(x))
        got = pm(torch.from_numpy(x), train=train,
                 bn_frozen=bn_frozen).detach().numpy()
        _close(got, want, 1e-4)
        load_jax_params(pm, case.vars["params"],
                        batch_stats=case.vars["batch_stats"])


def test_build_body_covers_the_archs():
    for arch in ("resnet18", "resnext50_32x4d", "se_resnet50",
                 "se_resnext50_32x4d", "senet154"):
        assert arch in vision.body_archs or arch.startswith("se")
    with pytest.raises(NotImplementedError, match="inceptionv4"):
        vision.build_body("inceptionv4", device="cpu")
    with pytest.raises(KeyError):
        vision.build_body("vgg16", device="cpu")
    assert resnet.resnet_split_prefixes((3, 4, 6, 3)) == \
        jresnet.resnet_split_prefixes((3, 4, 6, 3))
    assert senet.senet_split_prefixes((3, 8, 36, 3)) == \
        jsenet.senet_split_prefixes((3, 8, 36, 3))


def test_conv_nets_keep_channels_last():
    _, pm = _senet()
    w = pm.layer1_0.b2.conv.weight
    assert w.is_contiguous(memory_format=torch.channels_last)
    x = torch.randn(1, 33, 33, 3).permute(0, 3, 1, 2)
    assert pm(x).is_contiguous(memory_format=torch.channels_last)


def test_batchnorm_keeps_biased_variance_and_f32_buffers():
    bn = layers.BatchNorm(3)
    x = torch.randn(4, 3, 5, 5)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        bn(x.to(torch.bfloat16), use_running_average=False)
    assert bn.running_var.dtype == torch.float32
    bn2 = layers.BatchNorm(3)
    bn2(x, use_running_average=False)
    want = 0.9 + 0.1 * x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn2.running_var, want, rtol=1e-6, atol=1e-6)
    before = bn2.running_mean.clone()
    bn2.train()
    bn2(x)                      # default: running statistics, no update
    assert torch.equal(bn2.running_mean, before)
