"""Port of the training slice: schedules, optimizer, partition, loader,
loss and the Learner, each against the JAX package on the CPU.

Tolerances: schedules, loader batches and layer groups are exact (the
same numpy code or the same rule).  The optimizer runs 5 steps on the
same float32 tree with the same gradients: rtol 1e-5, atol 1e-7 (the
order of float32 operations differs: torch's fused addcdiv and foreach
ops).  The Learner test trains the same tiny flash-attention TransformerLM
from the same weights on the same batches with fit_one_cycle: per-step
losses to rtol 1e-5 and parameters to atol 2e-5, except the key-bias
columns of each qkv bias.  Their true gradient is exactly zero (adding a
constant to every key's logit leaves the softmax unchanged), so Adam
normalizes round-off noise there and those entries are held only to one
lr_max per step.
"""

import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.applications.text import (
    SeqCrossEntropyLoss as JaxSeqCE,
)
from neuralnetworklibrary_tpu.core import schedules as jax_sched
from neuralnetworklibrary_tpu.core.optim import Optimizer as JaxOptimizer
from neuralnetworklibrary_tpu.core.partition import (
    build_partition as jax_partition,
)
from neuralnetworklibrary_tpu.data import loader as jax_loader
from neuralnetworklibrary_tpu.learner import Learner as JaxLearner
from neuralnetworklibrary_tpu.nn.transformer import TransformerLM as JaxLM
from neuralnetworklibrary_tpu.parallel.mesh import get_mesh
from neuralnetworklibrary_tpu_torch.applications.text import (
    SeqCrossEntropyLoss,
)
from neuralnetworklibrary_tpu_torch.core import schedules
from neuralnetworklibrary_tpu_torch.core.optim import Optimizer
from neuralnetworklibrary_tpu_torch.core.partition import build_partition
from neuralnetworklibrary_tpu_torch.data import loader
from neuralnetworklibrary_tpu_torch.learner import Learner
from neuralnetworklibrary_tpu_torch.nn.transformer import TransformerLM
from neuralnetworklibrary_tpu_torch.utils.jax_params import (
    _flatten,
    _torch_name,
    load_jax_params,
)

V, T, BS = 64, 128, 2
LM = dict(vocab_size=V, d_model=32, n_heads=2, n_layers=2, max_len=T,
          drop=0.0, flash_attention=True)


# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("kind", ["linear", "cos", "exp", "poly"])
@pytest.mark.parametrize("vector", [False, True])
def test_get_sched_matches_jax(kind, vector):
    start, end = ([1e-3, 2e-3], [1e-1, 3e-2]) if vector else (1e-3, 1e-1)
    np.testing.assert_array_equal(schedules.get_sched(kind, 17, start, end),
                                  jax_sched.get_sched(kind, 17, start, end))


def test_one_cycle_and_cycles_match_jax():
    a = schedules.one_cycle_scheds(23, [1e-2, 5e-2], 25, 0.3)
    b = jax_sched.one_cycle_scheds(23, [1e-2, 5e-2], 25, 0.3)
    for key in ("lr", "mom", "beta1"):
        np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(
        schedules.cycles_sched(5, 1e-2, 1e-4, 3, "cos", 1, 2),
        jax_sched.cycles_sched(5, 1e-2, 1e-4, 3, "cos", 1, 2))


# ------------------------------------------------------------ optimizer


class _Toy(torch.nn.Module):
    """Parameters named like a flax tree {"body": {...}, "head": {...}}."""

    def __init__(self, tree):
        super().__init__()
        for mod, leaves in tree.items():
            self.add_module(mod, torch.nn.ParameterDict({
                k: torch.nn.Parameter(torch.tensor(v))
                for k, v in leaves.items()}))


def _toy_tree(rng):
    return {"body": {"b": rng.standard_normal(3).astype(np.float32),
                     "w": rng.standard_normal((4, 3)).astype(np.float32)},
            "head": {"w": rng.standard_normal((3, 2)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["SGD_Mom", "Adam2"])
def test_optimizer_matches_jax(name):
    """5 steps with two layer groups at different lr, wd and an active
    global-norm clip."""
    rng = np.random.default_rng(1)
    tree = _toy_tree(rng)
    groups = [["body"], ["head"]]
    lr, wd, clip = [0.01, 0.05], [1e-2, 1e-3], 0.5

    jopt = JaxOptimizer(name)
    jpart = jax_partition(tree, None, layer_groups=groups,
                          head_prefixes=("head",))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init(jparams)

    toy = _Toy(tree)
    opt = Optimizer(name)
    part = build_partition(toy, groups, ("head",))
    params = {tuple(n.split(".")): p for n, p in toy.named_parameters()}
    state = opt.init(params)
    assert part.group_idx == jpart.group_idx
    trainable = (True,) * len(part.paths)

    for step in range(5):
        grads = {m: {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in leaves.items()}
                 for m, leaves in tree.items()}
        jparams, jstate = jopt.apply(
            jparams, jax.tree_util.tree_map(jnp.asarray, grads), jstate,
            jpart, trainable, lr_groups=np.float32(lr),
            wd_groups=np.float32(wd), clip=clip)
        opt.apply(params, {p: torch.tensor(grads[p[0]][p[1]])
                           for p in params}, state, part, trainable,
                  lr_groups=lr, wd_groups=wd, clip=clip)
        for path, p in params.items():
            np.testing.assert_allclose(
                p.detach().numpy(), np.asarray(jparams[path[0]][path[1]]),
                rtol=1e-5, atol=1e-7, err_msg=f"step {step} {path}")


@pytest.mark.parametrize("name,args", [
    ("list_del", ([1, 2, 3, 4], [0, 2])), ("list_mult", ([1, 2], 3)),
    ("outer_mult", ([1, 2], [3, 4])), ("linear_space", (0.0, 1.0, 5)),
    ("broadcast_to_groups", (0.1, 3)),
    ("broadcast_to_groups", ([0.1, 0.2], 2))])
def test_pytree_helpers_match_jax(name, args):
    from neuralnetworklibrary_tpu.core import pytree as jax_pytree
    from neuralnetworklibrary_tpu_torch.core import pytree

    assert getattr(pytree, name)(*args) == getattr(jax_pytree, name)(*args)


def test_global_norm_matches_jax():
    from neuralnetworklibrary_tpu.core.pytree import (
        global_norm as jax_global_norm,
    )
    from neuralnetworklibrary_tpu_torch.core.pytree import global_norm

    leaves = list(_toy_tree(np.random.default_rng(4))["body"].values())
    np.testing.assert_allclose(
        float(global_norm([torch.tensor(a) for a in leaves])),
        float(jax_global_norm([jnp.asarray(a) for a in leaves])), rtol=1e-6)


@pytest.mark.parametrize("name", ["LAMB", "Lion", "Muon", "Adafactor"])
def test_unported_optimizers_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Optimizer(name)


# ------------------------------------------------------------ data, loss


def test_loader_matches_jax():
    """Same batches, masks and padding, shuffled over two epochs."""
    rng = np.random.default_rng(2)
    xs = rng.integers(0, V, (7, 5)).astype(np.int32)
    ys = rng.integers(0, V, (7, 5)).astype(np.int32)
    a = loader.DataLoader(loader.ArrayDataset(xs, ys), 3, shuffle=True,
                          seed=4)
    b = jax_loader.DataLoader(jax_loader.ArrayDataset(xs, ys), 3,
                              shuffle=True, seed=4)
    assert len(a) == len(b) == 3
    for _ in range(2):
        got, want = list(a), list(b)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.xs[0], w.xs[0])
            np.testing.assert_array_equal(g.y, w.y)
            np.testing.assert_array_equal(g.mask, w.mask)
            assert g.n_valid == w.n_valid


@pytest.mark.parametrize("masked", [False, True])
def test_seq_ce_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 5, V)).astype(np.float32)
    target = rng.integers(0, V, (3, 5)).astype(np.int32)
    mask = np.asarray([1, 1, 0], np.float32) if masked else None
    want = JaxSeqCE()((jnp.asarray(logits), None), jnp.asarray(target),
                      None if mask is None else jnp.asarray(mask))
    got = SeqCrossEntropyLoss()(
        (torch.tensor(logits), None), torch.tensor(target),
        None if mask is None else torch.tensor(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_layer_groups_match_jax():
    """Every parameter of the LM lands in the JAX model's group and head."""
    jm = JaxLM(**LM)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    jpart = jax_partition(params["params"], None, jm.layer_group_prefixes,
                          jm.head_prefixes)
    pm = TransformerLM(**LM, device="cpu")
    part = build_partition(pm, pm.layer_group_prefixes, pm.head_prefixes)
    want = {_torch_name(".".join(p)): (g, h) for p, g, h in
            zip(jpart.paths, jpart.group_idx, jpart.in_head)}
    got = {".".join(p): (g, h) for p, g, h in
           zip(part.paths, part.group_idx, part.in_head)}
    assert got == want
    assert not any(part.is_bn)


@pytest.mark.parametrize("flash", [True, False])
def test_d_ff_model_loads_and_matches_jax(flash):
    """A training TransformerLM with its own d_ff carries over through
    load_jax_params; logits and the loss gradient of the embedding match
    the JAX model (train=True at drop 0 runs the training path)."""
    kw = dict(LM, d_ff=48, flash_attention=flash)
    jm = JaxLM(**kw)
    x = np.random.default_rng(7).integers(0, V, (2, 40)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]

    def jloss(p):
        logits, _ = jm.apply({"params": p}, jnp.asarray(x), train=True)
        return jnp.mean(jnp.square(logits)), logits

    (_, want), grads = jax.value_and_grad(jloss, has_aux=True)(params)
    pm = load_jax_params(TransformerLM(**kw, device="cpu"),
                         jax.tree_util.tree_map(np.asarray, params))
    assert pm.block_0.mlp.fc_in.weight.shape == (48, 32)
    logits, _ = pm(torch.tensor(x), train=True)
    logits.square().mean().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(pm.word_embed.grad.numpy(),
                               np.asarray(grads["word_embed"]), rtol=0,
                               atol=1e-6)


# ------------------------------------------------------------ the slice


def _lm_data(ds_mod, dl_mod):
    rng = np.random.default_rng(0)
    starts = rng.integers(0, V, (7, 1))
    xs = ((starts + np.arange(T)) % V).astype(np.int32)
    ys = ((xs + 1) % V).astype(np.int32)
    ds = ds_mod(xs, ys)
    return types.SimpleNamespace(
        target_type="lang_model", bs=BS,
        train_dl=dl_mod(ds, BS, shuffle=True, prefetch=0),
        val_dl=dl_mod(ds, BS, prefetch=0))


def test_learner_matches_jax():
    """fit_one_cycle of a flash-attention TransformerLM, JAX Learner
    against the port's, from the same weights on the same batches (7 rows
    at bs 2, so every epoch ends on a short batch)."""
    jl = JaxLearner(tempfile.mkdtemp(),
                    _lm_data(jax_loader.ArrayDataset, jax_loader.DataLoader),
                    JaxLM(**LM), "Adam2", loss_func=JaxSeqCE(),
                    mesh=get_mesh(1), seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jl.params)
    pm = load_jax_params(TransformerLM(**LM, device="cpu"), tree)
    pl = Learner(tempfile.mkdtemp(),
                 _lm_data(loader.ArrayDataset, loader.DataLoader), pm,
                 "Adam2", loss_func=SeqCrossEntropyLoss(), seed=0,
                 device="cpu")
    lr_max, epochs = 5e-3, 2
    jl.fit_one_cycle(lr_max, epochs, wd=1e-4, clip=1.0)
    pl.fit_one_cycle(lr_max, epochs, wd=1e-4, clip=1.0)

    want = np.asarray([float(x) for x in jl.loss_sched])
    got = np.asarray([float(x) for x in pl.loss_sched])
    assert len(got) == len(want) == 8
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    np.testing.assert_allclose(pl.evaluate("val")[0], jl.evaluate("val")[0],
                               rtol=1e-5)

    port = dict(pm.named_parameters())
    D = LM["d_model"]
    for name, arr in _flatten(jax.tree_util.tree_map(np.asarray,
                                                     jl.params)):
        arr = arr.T if name.endswith(".kernel") and arr.ndim == 2 else arr
        p = port[_torch_name(name)].detach().numpy()
        if name.endswith("attn.qkv.bias"):
            keys = slice(D, 2 * D)
            assert np.abs(p[keys] - arr[keys]).max() <= lr_max * len(got)
            p, arr = np.delete(p, keys), np.delete(arr, keys)
        np.testing.assert_allclose(p, arr, rtol=0, atol=2e-5, err_msg=name)


def test_predict_and_evaluate_metrics_match_jax():
    """predict1minibatch logits and evaluate('val', metrics) over the
    padded, masked last batch, from the same weights."""
    jl = JaxLearner(tempfile.mkdtemp(),
                    _lm_data(jax_loader.ArrayDataset, jax_loader.DataLoader),
                    JaxLM(**LM), "Adam2", loss_func=JaxSeqCE(),
                    mesh=get_mesh(1), seed=1)
    pm = load_jax_params(TransformerLM(**LM, device="cpu"),
                         jax.tree_util.tree_map(np.asarray, jl.params))
    pl = Learner(tempfile.mkdtemp(),
                 _lm_data(loader.ArrayDataset, loader.DataLoader), pm,
                 "Adam2", loss_func=SeqCrossEntropyLoss(), device="cpu")
    x = pl.data.val_dl.peek().xs[0]
    np.testing.assert_allclose(pl.predict1minibatch(x)[0].numpy(),
                               np.asarray(jl.predict1minibatch(x)[0]),
                               rtol=0, atol=1e-5)
    got = pl.evaluate("val", [SeqCrossEntropyLoss()])
    want = jl.evaluate("val", [JaxSeqCE()])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_freeze_keeps_frozen_group_bit_identical():
    data = _lm_data(loader.ArrayDataset, loader.DataLoader)
    lm = TransformerLM(**LM, device="cpu")
    learner = Learner(tempfile.mkdtemp(), data, lm, "Adam2",
                      loss_func=SeqCrossEntropyLoss(), device="cpu")
    batch = data.train_dl.peek()

    def snapshot():
        return {n: p.detach().clone() for n, p in lm.named_parameters()}

    learner.freeze()
    before = snapshot()
    learner.train1minibatch(batch, 1e-2)
    after = snapshot()
    for name in before:
        same = torch.equal(before[name], after[name])
        assert same == (name != "word_embed"), name
    learner.unfreeze()
    learner.train1minibatch(batch, 1e-2)
    moved = snapshot()
    assert not torch.equal(moved["block_0.attn.qkv.weight"],
                           after["block_0.attn.qkv.weight"])


def test_save_load_round_trip():
    data = _lm_data(loader.ArrayDataset, loader.DataLoader)
    learner = Learner(tempfile.mkdtemp(), data,
                      TransformerLM(**LM, device="cpu"), "Adam2",
                      loss_func=SeqCrossEntropyLoss(), device="cpu")
    learner.save("start", save_optimizer=True)
    start = learner.evaluate("val")[0]
    learner.fit(1e-2, 1)
    assert learner.evaluate("val")[0] != start
    learner.load("start", saved_optimizer=True)
    assert learner.evaluate("val")[0] == start


def test_find_lr_records_and_restores():
    data = _lm_data(loader.ArrayDataset, loader.DataLoader)
    lm = TransformerLM(**LM, device="cpu")
    learner = Learner(tempfile.mkdtemp(), data, lm, "Adam2",
                      loss_func=SeqCrossEntropyLoss(), device="cpu")
    start = {n: p.detach().clone() for n, p in lm.named_parameters()}
    learner.find_lr(1e-5, 1e-1, length=6, break_fac=0)
    assert len(learner.loss_sched) == len(learner.lr_sched) == 6
    assert learner.lr_sched[0] < learner.lr_sched[-1]
    for n, p in lm.named_parameters():
        assert torch.equal(p, start[n]), n


@pytest.mark.parametrize("kw", [{"mesh": object()}, {"grad_accum": 2},
                                {"mixup": 0.2}, {"zero_sharding": True}])
def test_unported_learner_options_raise(kw):
    data = _lm_data(loader.ArrayDataset, loader.DataLoader)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Learner(tempfile.mkdtemp(), data, TransformerLM(**LM, device="cpu"),
                device="cpu", **kw)


def test_learner_needs_a_card_or_cpu(monkeypatch):
    data = _lm_data(loader.ArrayDataset, loader.DataLoader)
    model = TransformerLM(**LM, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Learner(tempfile.mkdtemp(), data, model)
