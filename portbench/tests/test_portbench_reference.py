"""Each family's plain reference against the port's CPU path at a tiny
width (loss, gradients and Adam2 updates agree in float32), and a run
with its timed path broken reading as not correct."""

import json
import time

import pytest

from portbench import harness

TINY = {
    "qwen3-0.6b": (
        dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             head_dim=32, intermediate_size=128, num_hidden_layers=2,
             vocab_size=512, max_position_embeddings=256),
        {"separator": 500, "pad": 511, "token_ids": [0, 500]},
        {"rows": 2, "seq_len": 64, "pool_batches": 4, "arrange": "pack",
         "doc_len": {"median": 12, "sigma": 1.0, "min": 2, "max": 63},
         "zipf": 1.1}),
    "gpt2-124m": (
        dict(n_embd=64, n_head=2, n_layer=2, vocab_size=300, n_positions=64),
        {"separator": 299, "pad": None, "token_ids": [0, 299]},
        {"rows": 4, "seq_len": 64, "pool_batches": 4, "arrange": "stream",
         "doc_len": {"median": 30, "sigma": 1.0, "min": 2, "max": 500},
         "zipf": 1.1}),
}
# float32 on both sides: the port's plain CPU path and the reference
# differ by the order of float32 sums alone
F32_LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4,
              "grad_diff": 1e-4, "packing_faults": 0}


def tiny_spec(config, dtype="float32"):
    sizes, bench, mix = TINY[config]
    with open(f"{harness.ROOT}/portbench/configs/{config}.json") as f:
        cfg = json.load(f)
    cfg.update(sizes, bench=bench)
    cfg["train"] = dict(cfg["train"], dtype=dtype)
    return {"cell": {"name": "tiny", "chips": 1}, "config": cfg, "mix": mix,
            "limits": F32_LIMITS,
            "end_to_end": [{"name": n, "unit": "u"} for n in
                           ("setup_s", "train_tokens_per_s", "peak_mem_gb")],
            "per_layer": []}


@pytest.mark.parametrize("config", sorted(TINY))
def test_reference_follows_the_port_in_float32(config):
    res = harness.run(tiny_spec(config), 2 ** 31 + 17, 0.2, False, "cpu",
                      time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(harness.FAULTS))
@pytest.mark.parametrize("config", sorted(TINY))
def test_a_broken_step_reads_as_not_correct(config, fault):
    res = harness.run(tiny_spec(config), 11, 0.2, False, "cpu",
                      time.perf_counter(), fault=fault)
    assert not res["correct"], res["checks"]


def test_the_control_reads_as_not_correct():
    """fp8 products in the program's place fail the float32 limits."""
    from portbench import control

    spec = tiny_spec("gpt2-124m")
    out = control.readings(spec, 3, "control", device="cpu")
    assert not out["correct"], out["values"]
