"""The result line has the keys its readers take, and run.py refuses to run
without a card."""

import json
import os
import subprocess
import sys
import time

from portbench import harness
from test_portbench_reference import tiny_spec

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


def test_result_line_keys_and_order():
    res = harness.run(tiny_spec("qwen3-0.6b"), 5, 0.2, False, "cpu",
                      time.perf_counter())
    line = json.loads(json.dumps(res))
    assert REQUIRED <= set(line) and "breakdown" not in line
    assert list(line)[-1] == "checks"
    assert DEVICE <= set(line["device"])
    assert set(line["metrics"]) == {"setup_s", "train_tokens_per_s",
                                    "peak_mem_gb"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    # no kernels are built off the card
    assert line["first_run"] == {"built_kernels": False, "build_s": 0.0}


def test_run_without_a_card_exits_without_a_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "gpt2-124m.stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=os.path.dirname(harness.HERE),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""
