"""Port of nn/vit.py against the JAX package on the CPU.

A 2-layer ViT (d 64, 2 heads, patch 8 at 32 px: 17 tokens) with the JAX
weights loaded by ``load_jax_params``, on NHWC images from a numpy seed.
The flash path runs ``ops.flash_attention``'s plain version here and JAX's
flash kernel in interpret mode (bidirectional, no bias, no mask).
Tolerances, float32: logits within 1e-4 x max|JAX logits|; the gradients
of the mean cross-entropy within 1e-3 x max|JAX gradient| of each leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neuralnetworklibrary_tpu.nn.vit import ViT as JaxViT
from neuralnetworklibrary_tpu_torch.nn.vit import ViT
from neuralnetworklibrary_tpu_torch.utils.jax_params import (
    _flatten,
    _torch_name,
    load_jax_params,
)

B, PX, NCLS = 2, 32, 5
CFG = dict(num_classes=NCLS, image_size=PX, patch=8, d_model=64, n_heads=2,
           n_layers=2, d_ff=96)
X = np.random.default_rng(0).standard_normal((B, PX, PX, 3)).astype(
    np.float32)
Y = np.random.default_rng(1).integers(0, NCLS, B)


def _pair(**kw):
    jm = JaxViT(**CFG, **kw)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                     jnp.asarray(X))["params"])
    pm = load_jax_params(ViT(**CFG, **kw, device="cpu"), params)
    return jm, params, pm


def _close(got, want, rel):
    want = np.asarray(want)
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), (
        np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("kw", [
    dict(pool="cls", norm_eps=1e-12, exact_gelu=True),
    dict(pool="mean"),
    dict(flash_attention=True),
], ids=["cls_hf_eps_gelu", "mean", "flash"])
def test_vit_forward_and_grads_match_jax(kw):
    jm, params, pm = _pair(**kw)

    def loss(p):
        logits = jm.apply({"params": p}, jnp.asarray(X))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(logp[jnp.arange(B), Y]), logits

    (_, want), gwant = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    logits = pm(torch.from_numpy(X))
    _close(logits.detach().numpy(), want, 1e-4)
    F.cross_entropy(logits, torch.from_numpy(Y)).backward()
    grads = {n: p.grad for n, p in pm.named_parameters()}
    for name, g in _flatten(jax.tree_util.tree_map(np.asarray, gwant)):
        g = (g.T if name.endswith(".kernel") and g.ndim == 2 else
             g.transpose(3, 2, 0, 1) if g.ndim == 4 else g)
        _close(grads[_torch_name(name)].numpy(), g, 1e-3)


def test_patch_tokens_are_row_major():
    """A patch conv that copies one pixel per patch puts patch (h, w) at
    token 1 + h * (W/P) + w, as the JAX reshape of NHWC does."""
    pm = ViT(**CFG, device="cpu")
    with torch.no_grad():
        pm.patch_embed.weight.zero_()
        pm.patch_embed.bias.zero_()
        pm.patch_embed.weight[0, 0, 0, 0] = 1.0
    x = torch.zeros(1, PX, PX, 3)
    for h in range(4):
        for w in range(4):
            x[0, 8 * h, 8 * w, 0] = 1 + h * 4 + w
    tokens = pm.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
    assert tokens[0, :, 0].tolist() == list(range(1, 17))


def test_vit_flash_path_uses_the_flash_op(monkeypatch):
    """flash_attention=True calls ops.flash_attention bidirectionally with
    no bias and no key mask, once per layer; False never calls it."""
    from neuralnetworklibrary_tpu_torch.nn import transformer

    calls = []
    real = transformer.flash_attention

    def spy(q, k, v, **kw):
        calls.append(kw)
        return real(q, k, v, **kw)

    monkeypatch.setattr(transformer, "flash_attention", spy)
    for flash in (True, False):
        calls.clear()
        pm = ViT(**CFG, flash_attention=flash, device="cpu")
        pm(torch.from_numpy(X))
        assert len(calls) == (CFG["n_layers"] if flash else 0)
        for kw in calls:
            assert kw["causal"] is False
            assert kw["bias"] is None and kw["kv_mask"] is None


def test_vit_layer_groups_and_options():
    jm = JaxViT(**CFG)
    pm = ViT(**CFG, device="cpu")
    assert pm.layer_group_prefixes == jm.layer_group_prefixes
    assert pm.head_prefixes == ("head",)
    with pytest.raises(NotImplementedError, match="lora"):
        ViT(**CFG, lora_rank=4, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        ViT(**CFG, pool="max", device="cpu")
    data = type("D", (), {"sz": PX, "classes": ["a", "b", "c"]})()
    m = ViT.from_dataobj(data, patch=8, d_model=64, n_heads=2, n_layers=1,
                         device="cpu")
    assert (m.num_classes, m.image_size) == (3, PX)
    assert m(torch.from_numpy(X)).shape == (B, 3)
