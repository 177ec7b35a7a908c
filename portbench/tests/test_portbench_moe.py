"""The expert-layer cell's pieces: the Qwen3-MoE family over its
configuration, its plain reference against HF's own Qwen3-MoE and the
port, the three readers on synthetic span records, planted faults at a
tiny size, and, on the card, that a traced step of the cell's layers waits
for the device nowhere inside the ``moe.*`` spans."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness, moe_roofline
from portbench.families import qwen3_moe as fam

ROOT = os.path.dirname(harness.HERE)
CELL = "sdar-30b-a3b.packed-web"
F32_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4,
              "packing_faults": 0}


def cfg():
    return harness.resolve(CELL, harness.manifest())["config"]


def tiny_spec():
    c = cfg()
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, moe_intermediate_size=32, num_hidden_layers=2,
             vocab_size=512, max_position_embeddings=256, num_experts=4,
             num_experts_per_tok=3,
             bench={"separator": 500, "pad": 511, "token_ids": [0, 500]})
    c["deployment"] = dict(c["deployment"], held_experts=[2, 6],
                           router_experts=8)
    c["train"] = dict(c["train"], dtype="float32")
    mix = {"rows": 2, "seq_len": 64, "pool_batches": 4, "arrange": "pack",
           "doc_len": {"median": 12, "sigma": 1.0, "min": 2, "max": 63},
           "zipf": 1.1}
    return {"cell": {"name": "tiny", "chips": 1}, "config": c, "mix": mix,
            "limits": F32_LIMITS,
            "end_to_end": [{"name": n, "unit": "u"} for n in
                           ("setup_s", "train_tokens_per_s", "peak_mem_gb")],
            "per_layer": []}


def test_the_family_over_the_configuration():
    c = cfg()
    d = fam.dims(c)
    assert (d["L"], d["H"], d["Hkv"], d["hd"]) == (4, 32, 4, 128)
    assert (d["D"], d["moe_ff"], d["moe_held"]) == (2048, 768, 128)
    # attention, the 128-wide router, the 8 experts of a token, all held,
    # and the untied head over the slice
    per_layer = (2 * 4096 + 2 * 512 + 128) * 2048 + 8 * 3 * 768 * 2048
    assert d["n_matmul"] == 4 * per_layer + 37984 * 2048
    c32 = dict(c, num_experts=32,
               deployment=dict(c["deployment"], held_experts=[0, 32]))
    assert fam.dims(c32)["n_matmul"] == d["n_matmul"] - 4 * (
        6 * 3 * 768 * 2048)          # 8 x 32 / 128 = 2 held a token
    leaves = fam.leaf_map(c)
    assert len(leaves) == 3 + 4 * (9 + 3)
    assert leaves["model.layers.3.mlp.experts.down_proj.weight"] == (
        "block_3.moe.w2", None)
    assert leaves["model.layers.0.mlp.gate.weight"] == ("block_0.moe.gate",
                                                        None)
    assert fam.trainable(c, "block_0.moe.w1")
    assert not any(fam.trainable(c, f"block_0.moe.{b}")
                   for b in ("b1", "b2", "b3"))
    assert not fam.trainable(c, "block_0.attn.qkv.bias")
    assert list(fam.reference.held(c)) == list(range(128))
    c["deployment"]["held_experts"] = [0, 16]
    with pytest.raises(ValueError, match="held"):
        fam.make_weights(c, 1, "cpu")


def test_the_reference_follows_hf_qwen3_moe():
    """The reference's loss of a model that holds every expert, against
    HF's ``Qwen3MoeForCausalLM`` built from a config object on the same
    weights (one document a row, no pads)."""
    transformers = pytest.importorskip("transformers")
    spec = tiny_spec()
    c = spec["config"]
    c["deployment"]["held_experts"] = [0, 8]
    c["num_experts"] = 8
    hf_cfg = transformers.Qwen3MoeConfig(
        vocab_size=512, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        num_experts=8, num_experts_per_tok=3, norm_topk_prob=True,
        decoder_sparse_step=1, mlp_only_layers=[], rope_theta=1e6,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        max_position_embeddings=256, attn_implementation="eager")
    hf = transformers.Qwen3MoeForCausalLM(hf_cfg).eval()
    weights = fam.make_weights(c, 3, "cpu")
    if set(hf.state_dict()) != set(weights):
        pytest.skip(f"transformers {transformers.__version__} lays out "
                    "Qwen3-MoE's experts otherwise than the per-expert "
                    "names of the published checkpoints")
    hf.load_state_dict(weights, strict=True)
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 500, (2, 24), generator=g)
    y = torch.randint(0, 500, (2, 24), generator=g)
    with torch.no_grad():
        logits = hf(x).logits
        want = torch.nn.functional.cross_entropy(logits.reshape(-1, 512),
                                                 y.reshape(-1))
        got = fam.reference.loss(fam.reference.params(weights), x, y, c,
                                 dict(c["bench"], separator=None, pad=None),
                                 "float32")
    assert abs(float(got - want)) <= 1e-5 * float(want)


def test_the_tiny_cell_is_correct_and_its_faults_are_not():
    res = harness.run(tiny_spec(), 2 ** 31 + 23, 0.2, False, "cpu",
                      time.perf_counter())
    assert res["correct"], res["checks"]
    for fault in sorted(harness.FAULTS):
        res = harness.run(tiny_spec(), 13, 0.2, False, "cpu",
                          time.perf_counter(), fault=fault)
        assert not res["correct"], (fault, res["checks"])


def _step(k, counters, parts):
    """A step span with counters and device spans of ``parts``
    {name: ms}."""
    t = 10_000 * k
    recs = [{"name": "learner.step", "id": 100 * k, "parent": None,
             "step": k, "thread": 1, "start_ns": t, "end_ns": t + 100,
             "self_ns": 10, "device_ms": None,
             "counters_in": {c: v * (k - 1) for c, v in counters.items()},
             "counters_out": {c: v * k for c, v in counters.items()}}]
    for i, (name, ms) in enumerate(parts.items()):
        recs.append({"name": name, "id": 100 * k + i + 1,
                     "parent": 100 * k, "step": k, "thread": 1,
                     "start_ns": t + i, "end_ns": t + i + 1, "self_ns": 1,
                     "device_ms": ms})
    return recs


PARTS = {"moe.router": 1.0, "moe.dispatch": 2.0, "moe.experts": 3.0,
         "moe.combine": 4.0, "moe.router.bwd": 5.0, "moe.dispatch.bwd": 6.0,
         "moe.experts.bwd": 7.0, "moe.combine.bwd": 8.0,
         "learner.forward": 100.0}


def _read(name, recs, dims=None):
    return harness.layer_metric(name).read(
        {"spans": {"spans": recs, "counters": {}}, "slice_steps": 4,
         "dims": dims, "dtype": "bfloat16"})


def test_the_readers_on_span_records():
    counters = {"moe_experts.assignments": 393_216}
    recs = [r for k in range(1, 7) for r in _step(k, counters, PARTS)]
    assert _read("moe_ms_per_step.train", recs) == 36.0
    assert _read("moe_route_ms_per_step.train", recs) == 26.0
    dims = fam.dims(cfg())
    least = moe_roofline.expert_least_seconds(393_216, 12, 32, 2048, 768)
    assert least == pytest.approx(18 * 2048 * 768 * 393_216 / 989e12)
    got = _read("moe_gemm_roofline.train", recs, dims)
    assert got == pytest.approx(100 * least / 10e-3)
    # a port without expert layers, or without the counter, reads nothing
    plain = [r for k in range(1, 7)
             for r in _step(k, {"flash_fwd.launches": 12},
                            {"learner.forward": 9.0})]
    for name in ("moe_ms_per_step.train", "moe_route_ms_per_step.train",
                 "moe_gemm_roofline.train"):
        assert _read(name, plain, dims) is None


def test_the_expert_byte_count():
    A, L, E, D, F = 1000, 2, 4, 64, 32
    want = 2 * (3 * 3 * E * D * F * L + 5 * D * A)
    assert moe_roofline.expert_bytes(A, L, E, D, F) == want
    tiny = moe_roofline.expert_least_seconds(A, L, E, D, F)
    assert tiny == pytest.approx(want / 3.35e12)


def test_the_reference_loads_no_program_and_no_jax():
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import portbench.reference.qwen3_moe; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & (set(harness.FORBIDDEN)
                       | {"neuralnetworklibrary_tpu_torch"})


@pytest.mark.card
@pytest.mark.parametrize("held, layers", [(None, None), ((0, 32), 2)])
def test_a_traced_step_of_the_cells_layers_waits_nowhere(card, held,
                                                         layers):
    """The cell's expert layers at its own sizes (and one chip's share of
    expert parallelism 4: experts 0-31 of the 128), in one traced
    training step: no synchronizing call inside a ``moe.*`` span, one
    grouped product call a layer and forward."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from neuralnetworklibrary_tpu_torch.ops import moe
    from portbench import spans as port_spans
    from portbench import trace

    spec = harness.resolve(CELL, harness.manifest())
    c = spec["config"]
    if held is not None:
        c = dict(c, num_experts=held[1] - held[0], num_hidden_layers=layers,
                 deployment=dict(c["deployment"], held_experts=list(held)))
    L = c["num_hidden_layers"]
    pool = harness.make_pool(c, spec["mix"], 20260504)
    weights = fam.make_weights(c, 20260504, card)
    with tempfile.TemporaryDirectory() as tmp:
        learner = harness.build_learner(c, weights, pool, 20260504, card,
                                        tmp)
        del weights
        batches = harness.feed(learner)
        learner.train1minibatch(next(batches), c["train"]["lr"])
        torch.cuda.synchronize()
        before = moe.moe_experts.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss = learner.train1minibatch(next(batches), c["train"]["lr"])
            torch.cuda.synchronize()
        assert moe.moe_experts.launches - before == L
        assert torch.isfinite(loss)
        _, host = trace.profiler_events(prof)
        in_moe = [e for e in host if e[0].startswith("nnl/moe.")]
        waits = [e for e in host if e[0] in port_spans.SYNCS
                 and any(a <= e[1] and e[2] <= b for _, a, b in in_moe)]
        assert len(in_moe) == L * 8 and not waits, waits
