"""The port's dropless top-k expert layer (``nn.transformer.MoEMLP``,
``ops.moe``) on the CPU, at D 64, 8 experts of width 32, top-2 and top-4:
against the benchmark's plain Qwen3-MoE reference
(``portbench/reference/qwen3_moe.py``) for the layer, for a 2-layer
``TransformerLM`` built by ``load_qwen3_moe`` (loss, the gradient of every
leaf, one Adam2 step through the ``Learner``), held ranges that add up to
the whole layer, the JAX package's ``MoEMLP(gated=True, eval_dense=True)``,
the converters, a skewed router, the GShard option that still raises, and
the spans and counters.

Tolerances (float32 on both sides, sums in other orders): outputs and
gradients 1e-5 of their largest entry; the parts of the held ranges
against the whole layer the same.  Those are far under what a bf16
router (weights off by ~2e-3 of themselves) or one expert's part left
out (a whole expert's share of the output) moves, as the tests check.
One Adam2 step 1e-2 of the rate: a first Adam step moves each element by
lr g / (|g| + eps), the rate times the sign of a gradient well above eps,
and float32 noise moves it for the few gradients within ~100 eps of 0.
"""

import json
import tempfile

import jax
import numpy as np
import pytest
import torch

from neuralnetworklibrary_tpu.nn import transformer as jtr
from neuralnetworklibrary_tpu_torch.nn import transformer as tr
from neuralnetworklibrary_tpu_torch.ops import moe
from neuralnetworklibrary_tpu_torch.utils import llama_convert as conv
from neuralnetworklibrary_tpu_torch.utils import tracing
from neuralnetworklibrary_tpu_torch.utils.safetensors_io import (
    save_safetensors,
)
from portbench import harness
from portbench.families import qwen3_moe as fam
from portbench.reference import common
from portbench.reference import qwen3_moe as ref

D, FF, N_EXP, TOL = 64, 32, 8, 1e-5
MIX = {"rows": 2, "seq_len": 32, "pool_batches": 3, "arrange": "pack",
       "doc_len": {"median": 8, "sigma": 1.0, "min": 2, "max": 31},
       "zipf": 1.1}


def tiny_cfg(k=2, held=(2, 6), layers=2):
    with open(f"{harness.ROOT}/portbench/configs/sdar-30b-a3b.json") as f:
        cfg = json.load(f)
    cfg.update(hidden_size=D, num_attention_heads=4, num_key_value_heads=2,
               head_dim=16, moe_intermediate_size=FF,
               num_hidden_layers=layers, vocab_size=96,
               max_position_embeddings=64, num_experts=held[1] - held[0],
               num_experts_per_tok=k,
               bench={"separator": 94, "pad": 95, "token_ids": [0, 94]})
    cfg["deployment"] = dict(cfg["deployment"], held_experts=list(held),
                             router_experts=N_EXP)
    cfg["train"] = dict(cfg["train"], dtype="float32")
    return cfg


def close(got, want, tol=TOL):
    got, want = got.detach(), want.detach()
    scale = want.abs().max().clamp_min(1e-30)
    return float((got - want).abs().max() / scale) <= tol


def layer_and_weights(k, held, seed=0):
    """The port's layer holding ``held`` of 8, and the reference's HF-named
    weights of all 8 experts (zero biases: Qwen3-MoE has none)."""
    g = torch.Generator().manual_seed(seed)
    gate = torch.randn(N_EXP, D, generator=g) * 0.3
    ws = {e: [torch.randn(FF, D, generator=g) * 0.2,
              torch.randn(FF, D, generator=g) * 0.2,
              torch.randn(D, FF, generator=g) * 0.2] for e in range(N_EXP)}
    layer = tr.MoEMLP(D, FF, N_EXP, k, experts=held, device="cpu")
    with torch.no_grad():
        layer.gate.copy_(gate.T)
        for i, e in enumerate(range(*held)):
            layer.w1[i].copy_(ws[e][0].T)
            layer.w3[i].copy_(ws[e][1].T)
            layer.w2[i].copy_(ws[e][2].T)
    return layer, gate, ws


def ref_layer(x, gate, ws, k, held):
    cfg = {"num_experts_per_tok": k, "deployment": {"held_experts": held}}
    stacked = [torch.stack([ws[e][j] for e in range(*held)])
               for j in range(3)]
    return ref.experts(cfg, "float32", x, gate, *stacked)


@pytest.mark.parametrize("k", [2, 4])
def test_layer_matches_the_reference_forward_and_gradients(k,
                                                           monkeypatch):
    held = (2, 6)
    layer, gate, ws = layer_and_weights(k, held)
    x = torch.randn(48, D, generator=torch.Generator().manual_seed(1))
    xp = x.clone().requires_grad_(True)
    out = layer(xp)
    leaves = [gate] + [w for e in range(*held) for w in ws[e]]
    xr = x.clone().requires_grad_(True)
    for t in leaves:
        t.requires_grad_(True)
    want = ref_layer(xr, gate, ws, k, held)
    assert close(out, want)
    gy = torch.randn(want.shape, generator=torch.Generator().manual_seed(2))
    (out * gy).sum().backward()
    grads = torch.autograd.grad((want * gy).sum(), [xr] + leaves)
    assert close(xp.grad, grads[0])
    assert close(layer.gate.grad, grads[1].T)
    for i in range(held[1] - held[0]):
        for port, got in zip((layer.w1, layer.w3, layer.w2),
                             grads[2 + 3 * i:5 + 3 * i]):
            assert close(port.grad[i], got.T)
    # a bf16 router, or one held expert's part left out, fails these
    monkeypatch.setattr(moe, "ROUTER_DTYPE", torch.bfloat16)
    assert not close(layer(x), want.detach())
    monkeypatch.undo()
    short, _, _ = layer_and_weights(k, (3, 6))
    assert not close(short(x), want.detach())


def test_held_parts_add_up_to_the_whole_layer():
    """Four chips' shares of two experts each add up to the layer that
    holds all eight, within float32 round-off; three of them do not."""
    x = torch.randn(64, D, generator=torch.Generator().manual_seed(3))
    whole, gate, ws = layer_and_weights(4, (0, N_EXP))
    parts = [layer_and_weights(4, (e, e + 2))[0](x) for e in (0, 2, 4, 6)]
    with torch.no_grad():
        want = whole(x)
        assert close(ref_layer(x, gate, ws, 4, (0, N_EXP)), want)
        assert close(sum(parts), want)
        assert not close(sum(parts[:3]), want)


@pytest.mark.parametrize("k", [2, 4])
def test_forward_matches_the_jax_eval_dense_experts(k):
    jm = jtr.MoEMLP(D, FF, N_EXP, top_k=k, gated=True, eval_dense=True)
    x = np.random.default_rng(4).standard_normal((2, 12, D)).astype(
        np.float32)
    rng = np.random.default_rng(5)
    params = {n: (np.asarray(v) + (0.1 * rng.standard_normal(v.shape)
                                   if n[0] == "b" else 0)).astype(np.float32)
              for n, v in jm.init(jax.random.PRNGKey(k), x)["params"].items()}
    # (the biases made nonzero)
    want, _ = jm.apply({"params": params}, x, train=False)
    layer = tr.MoEMLP(D, FF, N_EXP, k, device="cpu")
    with torch.no_grad():
        for n, v in params.items():
            getattr(layer, n).copy_(torch.from_numpy(v))
        got = layer(torch.from_numpy(x))
    assert close(got, torch.from_numpy(np.asarray(want)))


def lm_and_batch(k=2, held=(2, 6), seed=7):
    cfg = tiny_cfg(k, held)
    weights = fam.make_weights(cfg, seed, "cpu")
    pool = harness.make_pool(cfg, MIX, seed)
    x, y = (torch.from_numpy(a[:2]).long() for a in (pool["x"], pool["y"]))
    return cfg, weights, pool, x, y


def test_small_lm_loss_gradients_and_a_learner_step_match_the_reference():
    cfg, weights, pool, x, y = lm_and_batch()
    model = fam.build(cfg, weights, "cpu")
    loss = fam.loss_func(cfg)(model(x, train=True), y)
    loss.backward()
    p = ref.params(weights)
    want = ref.loss(p, x, y, cfg, cfg["bench"], "float32")
    want.backward()
    assert abs(float(loss - want)) <= TOL * float(want)
    params = dict(model.named_parameters())
    for name, (port, rows) in fam.leaf_map(cfg).items():
        got = params[port].grad
        got = got if rows is None else got[rows[0]:rows[1]]
        assert close(got, fam.port_layout(name, p[name].grad)), name
    # one Adam2 step through the Learner against the reference's
    with tempfile.TemporaryDirectory() as tmp:
        learner = harness.build_learner(cfg, fam.make_weights(cfg, 7, "cpu"),
                                        pool, 7, "cpu", tmp)
        batch = next(iter(learner.data.train_dl))
        learner.train1minibatch(batch, cfg["train"]["lr"])
    p = ref.params(weights)
    opt = {n: cfg["train"][n] for n in ("lr", "wd", "betas", "eps")}
    common.train(p, lambda q, a, b: ref.loss(q, a, b, cfg, cfg["bench"],
                                             "float32"),
                 [tuple(torch.from_numpy(a[:2]).long()
                        for a in (batch.xs[0], batch.y))], opt)
    params = dict(learner.model.named_parameters())
    lr = cfg["train"]["lr"]
    for name, (port, rows) in fam.leaf_map(cfg).items():
        got = params[port].detach()
        got = got if rows is None else got[rows[0]:rows[1]]
        diff = (got - fam.port_layout(name, p[name].detach())).abs().max()
        assert float(diff) <= 1e-2 * lr, name


def hf_dir(tmp, cfg, weights, **changes):
    save_safetensors({k: v.numpy() for k, v in weights.items()},
                     f"{tmp}/model.safetensors")
    keys = ("hidden_size", "num_attention_heads", "num_key_value_heads",
            "head_dim", "num_hidden_layers", "vocab_size",
            "max_position_embeddings", "rope_theta", "rms_norm_eps",
            "norm_topk_prob", "decoder_sparse_step", "mlp_only_layers",
            "num_experts_per_tok", "moe_intermediate_size",
            "intermediate_size", "tie_word_embeddings")
    hf = {k: cfg[k] for k in keys}
    hf.update(model_type="qwen3_moe", num_experts=N_EXP, **changes)
    with open(f"{tmp}/config.json", "w") as f:
        json.dump(hf, f)


def test_converters_build_the_model_from_hf_names():
    cfg, weights, _, x, _ = lm_and_batch(k=4, held=(0, N_EXP), seed=9)
    model, tree = conv.load_qwen3_moe(
        weights, 2, n_heads=4, d_model=D, vocab_size=96, head_dim=16,
        n_experts=N_EXP, moe_top_k=4, d_ff=FF, n_kv_heads=2, device="cpu")
    assert set(tree["block_0"]) == {"ln1", "ln2", "attn", "moe"}
    blk = model.block_1.moe
    np.testing.assert_array_equal(
        blk.w1[3].detach().numpy(),
        weights["model.layers.1.mlp.experts.3.gate_proj.weight"].T.numpy())
    assert not model.tied_decoder and not any(
        blk.b1.detach().flatten().tolist())
    with torch.no_grad():
        logits = model(x)[0]
    # the held experts alone are read: experts 2-5 of a state dict of 8
    part, _ = conv.load_qwen3_moe(
        {k: v for k, v in weights.items()
         if ".experts." not in k or int(k.split(".")[5]) in range(2, 6)},
        2, n_heads=4, d_model=D, vocab_size=96, head_dim=16,
        n_experts=N_EXP, moe_top_k=4, d_ff=FF, n_kv_heads=2,
        moe_experts=(2, 6), device="cpu")
    assert part.block_0.moe.w1.shape == (4, D, FF)
    with tempfile.TemporaryDirectory() as tmp:
        hf_dir(tmp, cfg, weights)
        read, _ = conv.load_llama_dir(tmp, device="cpu")
        with torch.no_grad():
            assert torch.equal(read(x)[0], logits)
        assert read.block_0.moe.top_k == 4
        for bad in (dict(decoder_sparse_step=2), dict(mlp_only_layers=[0]),
                    dict(norm_topk_prob=False)):
            hf_dir(tmp, cfg, weights, **bad)
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                conv.load_llama_dir(tmp, device="cpu")


def test_a_skewed_router_drops_no_token():
    """A router that sends every token to the same four experts, all
    held: every assignment is computed, as the reference computes it."""
    layer, gate, ws = layer_and_weights(4, (0, N_EXP), seed=11)
    with torch.no_grad():
        gate[:4] += 50.0
        layer.gate.copy_(gate.T)
    x = torch.randn(40, D, generator=torch.Generator().manual_seed(12))
    tracing.reset()
    tracing.enable()
    try:
        before = tracing.counters()["moe_experts.assignments"]
        with torch.no_grad():
            got = layer(x)
        held = int(tracing.counters()["moe_experts.assignments"] - before)
    finally:
        tracing.disable()
        tracing.reset()
    assert held == 40 * 4
    assert close(got, ref_layer(x, gate, ws, 4, (0, N_EXP)))


@pytest.mark.parametrize("option", [dict(capacity_factor=1.25),
                                    dict(mlp="gelu")])
def test_gshard_capacity_routing_and_ungated_experts_raise(option):
    kw = dict(vocab_size=96, d_model=D, n_heads=4, n_layers=2, d_ff=FF,
              mlp="swiglu", n_experts=N_EXP, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tr.TransformerLM(**dict(kw, **option))
    m = tr.TransformerLM(**dict(kw, moe_top_k=4))
    # the JAX rule: block i holds experts when (i + 1) % moe_every == 0
    assert hasattr(m.block_1, "moe") and hasattr(m.block_0, "mlp")


def test_spans_and_counters_of_a_training_step():
    cfg, weights, _, x, y = lm_and_batch()
    model = fam.build(cfg, weights, "cpu")
    inputs = []
    for blk in model.blocks():
        blk.moe.register_forward_pre_hook(
            lambda mod, args: inputs.append((mod, args[0].detach())))
    launches = moe.moe_experts.launches
    tracing.reset()
    tracing.enable()
    try:
        with tracing.span("learner.step", step=1):
            fam.loss_func(cfg)(model(x, train=True), y).backward()
        snap = tracing.snapshot()
    finally:
        tracing.disable()
        tracing.reset()
    assert moe.moe_experts.launches - launches == 2    # one per layer
    names = [s["name"] for s in snap["spans"]]
    parts = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")
    for part in parts:
        assert names.count(part) == names.count(part + ".bwd") == 2
    step = next(s for s in snap["spans"] if s["name"] == "learner.step")
    held = (step["counters_out"]["moe_experts.assignments"]
            - step["counters_in"]["moe_experts.assignments"])
    want = 0
    for mod, inp in inputs:       # each layer's held selections, by hand
        idx = (inp.reshape(-1, D) @ mod.gate).topk(mod.top_k, -1).indices
        want += int(((idx >= 2) & (idx < 6)).sum())
    assert held == want > 0
    # off, the layer counts calls but sums nothing on the device
    before = tracing.counters()["moe_experts.assignments"]
    with torch.no_grad():
        model(x)
    assert int(tracing.counters()["moe_experts.assignments"]) == int(before)


def test_lm_learner_trains_through_the_expert_layers():
    cfg, weights, pool, _, _ = lm_and_batch(k=2, held=(0, N_EXP))
    with tempfile.TemporaryDirectory() as tmp:
        learner = harness.build_learner(cfg, weights, pool, 7, "cpu", tmp)
        batches = harness.feed(learner)
        losses = [float(learner.train1minibatch(next(batches), 3e-3))
                  for _ in range(6)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert isinstance(learner.model.block_0.moe, tr.MoEMLP)
