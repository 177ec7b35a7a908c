"""On the card: the control and each fault planted under the timed path, at
a cell's own size, read as not correct, and a traced run carries the
device's busy and window seconds and its per-layer metrics."""

import json
import os
import subprocess
import sys

import pytest

from portbench import control, harness

ROOT = os.path.dirname(harness.HERE)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()[
    "workloads"]])
def test_the_control_at_the_cells_size_is_not_correct(card, cell):
    spec = harness.resolve(cell, harness.manifest())
    out = control.readings(spec, 20260501, "control", device=card)
    assert not out["correct"], out["values"]


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(harness.FAULTS))
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()[
    "workloads"]])
def test_a_planted_fault_at_the_cells_size_is_not_correct(card, cell,
                                                          fault):
    spec = harness.resolve(cell, harness.manifest())
    out = control.readings(spec, 20260503, fault, device=card)
    assert not out["correct"], out["values"]


@pytest.mark.card
def test_a_traced_run_reads_its_layers(card):
    cell = "gpt2-124m.stream"
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "20260502", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=ROOT, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    spec = harness.resolve(cell, harness.manifest())
    assert set(line["metrics"]) == {m["name"] for m in spec["per_layer"]}
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, name
    assert len(line["breakdown"]["device_ops"]) <= 10
