"""The reader of the port's padded-head counter,
``head_pad_launches_per_step.train``: one call a step where the counter
moves, zero where it is present and still, and nothing (no error) on a
port that has no such counter, as the parent of the change that added it
has not."""

import pytest

from portbench import harness

NAME = "head_pad_launches_per_step.train"
COUNTER = "padded_head.launches"


def _run(n_steps=6, per_step=1, counter=True):
    """Records of ``n_steps`` steps whose counters move by ``per_step``."""
    recs, count = [], {"flash_fwd.launches": 0}
    if counter:
        count[COUNTER] = 0
    for k in range(1, n_steps + 1):
        before = dict(count)
        count["flash_fwd.launches"] += 12
        if counter:
            count[COUNTER] += per_step
        t = 10_000 * k
        recs.append({"name": "learner.step", "id": k, "parent": None,
                     "step": k, "thread": 1, "start_ns": t,
                     "end_ns": t + 100, "self_ns": 100, "device_ms": None,
                     "counters_in": before, "counters_out": dict(count)})
    return {"spans": recs, "counters": count}


def _read(run):
    return harness.layer_metric(NAME).read({"spans": run, "slice_steps": 4})


@pytest.mark.parametrize("per_step, want", [(1, 1.0), (0, 0.0), (3, 3.0)])
def test_the_calls_a_step_over_the_slice(per_step, want):
    assert _read(_run(per_step=per_step)) == want


def test_a_port_without_the_counter_reads_nothing():
    assert _read(_run(counter=False)) is None


def test_a_run_without_spans_reads_nothing():
    assert _read({"spans": [], "counters": {}}) is None


def test_the_ports_live_record_reads_zero_off_the_padded_path():
    """The port's own record, as a traced ``run.py`` run reads it: two
    steps with no head product count 0 calls a step."""
    from neuralnetworklibrary_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    try:
        for k in (1, 2):
            with tracing.span("learner.step", step=k):
                pass
    finally:
        tracing.disable()
    try:
        assert harness.layer_metric(NAME).read({"slice_steps": 2}) == 0.0
    finally:
        tracing.reset()
