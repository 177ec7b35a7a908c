"""The long-context cell's pieces: the Mellum family over its configuration,
the books-32k mix, the four attention readers on synthetic span records
(and on records without their spans or counters, as a port without them
leaves), a tiny cell of the family on the CPU that is correct while its
faults are not, and, on the card, the two faults of this model planted at
the cell's size: full attention in the sliding layers, and the sliding
layers' rotary phases on the full layer."""

import json
import os
import subprocess
import sys
import time

import pytest

from portbench import control, harness, roofline, traffic
from portbench.families import mellum as fam

ROOT = os.path.dirname(harness.HERE)
CELL = "mellum2-12b-a2.5b.books-32k"
F32_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4}


def _full_in_sliding(learner):
    """Every layer attends its whole document: the windows are gone."""
    for block in learner.model.blocks():
        block.attn.window = 0


def _sliding_rope_on_full(learner):
    """The full layers turn by the sliding layers' phases (no YaRN)."""
    blocks = learner.model.blocks()
    sliding = next(b.attn for b in blocks if b.attn.window > 0)
    for b in blocks:
        if b.attn.window == 0:
            b.attn.rope_base = sliding.rope_base
            b.attn.rope_scaling = sliding.rope_scaling


FAULTS = {"full_in_sliding": _full_in_sliding,
          "sliding_rope_on_full": _sliding_rope_on_full}


def cfg():
    return harness.resolve(CELL, harness.manifest())["config"]


def tiny_spec():
    c = cfg()
    c.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, moe_intermediate_size=32, vocab_size=512,
             max_position_embeddings=256, num_experts=8,
             num_experts_per_tok=3, sliding_window=8,
             bench={"separator": 510, "pad": 511, "token_ids": [0, 510]})
    c["rope_parameters"] = dict(c["rope_parameters"], full_attention=dict(
        c["rope_parameters"]["full_attention"],
        original_max_position_embeddings=16))
    c["deployment"] = dict(c["deployment"], held_experts=[0, 8],
                           router_experts=8)
    c["train"] = dict(c["train"], dtype="float32")
    mix = {"rows": 1, "seq_len": 96, "pool_batches": 4, "arrange": "stream",
           "doc_len": {"median": 30, "sigma": 0.75, "min": 4, "max": 200},
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
    assert (d["D"], d["moe_ff"], d["moe_held"]) == (2304, 896, 64)
    assert d["windows"] == [1024, 1024, 1024, 0]
    assert d["separator"] == 24574
    # attention, the 64-wide router, a token's 8 experts, and the head
    per_layer = (2 * 4096 + 2 * 512 + 64) * 2304 + 8 * 3 * 896 * 2304
    assert d["n_matmul"] == 4 * per_layer + 24576 * 2304
    assert c["layer_types"] == ["sliding_attention"] * 3 + ["full_attention"]
    assert c["mlp_layer_types"] == ["sparse"] * 4
    assert c["rope_parameters"]["full_attention"]["rope_type"] == "yarn"
    assert sorted(c["reduced"]) == sorted(
        ["num_hidden_layers", "vocab_size", "layer_types", "mlp_layer_types"])


def test_the_mix_file():
    mix = traffic.load("books-32k")
    assert (mix["rows"], mix["seq_len"], mix["pool_batches"]) == (1, 32768,
                                                                  24)
    assert (mix["arrange"], mix["zipf"]) == ("stream", 1.1)
    assert mix["doc_len"] == traffic.load("long-docs")["doc_len"]
    assert mix["source"] == traffic.load("long-docs")["source"]
    assert cfg()["bench"]["token_ids"] == [0, 24574]


def test_the_tiny_cell_is_correct_and_its_faults_are_not(monkeypatch):
    res = harness.run(tiny_spec(), 2 ** 31 + 29, 0.2, False, "cpu",
                      time.perf_counter())
    assert res["correct"], res["checks"]
    for name, fault in FAULTS.items():
        monkeypatch.setitem(harness.FAULTS, name, fault)
    for fault in sorted(harness.FAULTS):
        res = harness.run(tiny_spec(), 17, 0.2, False, "cpu",
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


PARTS = {"attention.sliding": 3.0, "attention.sliding.bwd": 9.0,
         "attention.full": 20.0, "attention.full.bwd": 50.0,
         "attention.fwd": 1.0, "learner.forward": 100.0}
PAIRS = {"attention.sliding_pairs": 3 * 32_000_000,
         "attention.full_pairs": 490_000_000}


def _read(name, recs, dims):
    return harness.layer_metric(name).read(
        {"spans": {"spans": recs, "counters": {}}, "slice_steps": 4,
         "dims": dims, "dtype": "bfloat16", "rows": 1, "seq_len": 32768})


def test_the_readers_on_span_records():
    dims = fam.dims(cfg())
    recs = [r for k in range(1, 7) for r in _step(k, PAIRS, PARTS)]
    assert _read("attn_sliding_ms_per_step.train", recs, dims) == 12.0
    assert _read("attn_full_ms_per_step.train", recs, dims) == 70.0
    for kind, ms, layers in (("sliding", 12.0, 3), ("full", 70.0, 1)):
        pairs = PAIRS[f"attention.{kind}_pairs"]
        least = layers * roofline.attention_least_seconds(
            pairs / layers, 1, 32768, 32, 4, 128, True)
        assert least == pytest.approx(14 * 128 * pairs * 32 / 989e12)
        got = _read(f"flash_{kind}_roofline.train", recs, dims)
        assert got == pytest.approx(100 * least / (ms / 1e3))
    # a port without the spans, or without the counters, reads nothing
    plain = [r for k in range(1, 7)
             for r in _step(k, {"flash_fwd.launches": 4},
                            {"attention.fwd": 1.0, "learner.forward": 9.0})]
    uncounted = [r for k in range(1, 7)
                 for r in _step(k, {"flash_fwd.launches": 4}, PARTS)]
    for name in ("attn_sliding_ms_per_step.train",
                 "attn_full_ms_per_step.train",
                 "flash_sliding_roofline.train", "flash_full_roofline.train"):
        assert _read(name, plain, dims) is None, name
        if "roofline" in name:
            assert _read(name, uncounted, dims) is None, name
    assert _read("flash_sliding_roofline.train", [], dims) is None


def test_the_reference_loads_no_program_and_no_jax():
    code = ("import sys, json; sys.path.insert(0, %r); "
            "import portbench.reference.mellum; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not mods & (set(harness.FORBIDDEN)
                       | {"neuralnetworklibrary_tpu_torch"})


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_this_models_faults_at_the_cells_size_are_not_correct(
        card, fault, monkeypatch):
    monkeypatch.setitem(harness.FAULTS, fault, FAULTS[fault])
    spec = harness.resolve(CELL, harness.manifest())
    out = control.readings(spec, 20260505, fault, device=card)
    print(json.dumps(out))
    assert not out["correct"], out["values"]
