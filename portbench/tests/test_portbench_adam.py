"""The readers of the port's fused Adam counters:
``adam_launches_per_step.train``, the launches a step where the counter
moves, and ``adam_kernel_share.train``, the share of the trained elements
the kernel updated; each reads nothing (no error) on a port that has no
such counter, as the parent of the change that added them has not."""

import pytest

from portbench import harness

NAME = "adam_launches_per_step.train"
SHARE = "adam_kernel_share.train"
COUNTER = "adam.launches"
ELEMENTS = "adam.elements"


def _run(n_steps=6, per_step=1, counter=True, elements=None, trained=100):
    """Records of ``n_steps`` steps whose launch counter moves by
    ``per_step`` and element counter by ``elements`` (``trained``, the
    elements each step's optimizer span records, by default)."""
    elements = trained if elements is None else elements
    recs, count = [], {"flash_fwd.launches": 0}
    if counter:
        count[COUNTER] = count[ELEMENTS] = 0
    for k in range(1, n_steps + 1):
        before = dict(count)
        count["flash_fwd.launches"] += 28
        if counter:
            count[COUNTER] += per_step
            count[ELEMENTS] += elements
        t = 10_000 * k
        recs.append({"name": "learner.step", "id": 2 * k, "parent": None,
                     "step": k, "thread": 1, "start_ns": t,
                     "end_ns": t + 100, "self_ns": 100, "device_ms": None,
                     "counters_in": before, "counters_out": dict(count)})
        recs.append({"name": "learner.optimizer", "id": 2 * k + 1,
                     "parent": 2 * k, "step": k, "thread": 1,
                     "start_ns": t + 50, "end_ns": t + 90, "self_ns": 40,
                     "device_ms": None, "elements": trained,
                     "counters_in": before, "counters_out": dict(count)})
    return {"spans": recs, "counters": count}


def _read(run, name=NAME):
    return harness.layer_metric(name).read({"spans": run, "slice_steps": 4})


@pytest.mark.parametrize("per_step, want", [(1, 1.0), (0, 0.0), (5, 5.0)])
def test_the_launches_a_step_over_the_slice(per_step, want):
    assert _read(_run(per_step=per_step)) == want


@pytest.mark.parametrize("elements, want", [(100, 100.0), (0, 0.0),
                                             (25, 25.0)])
def test_the_share_of_trained_elements_through_the_kernel(elements, want):
    assert _read(_run(elements=elements), SHARE) == want


@pytest.mark.parametrize("name", [NAME, SHARE])
def test_a_port_without_the_counter_reads_nothing(name):
    assert _read(_run(counter=False), name) is None


@pytest.mark.parametrize("name", [NAME, SHARE])
def test_a_run_without_spans_reads_nothing(name):
    assert _read({"spans": [], "counters": {}}, name) is None


def test_a_run_that_trains_nothing_has_no_share():
    assert _read(_run(elements=0, trained=0), SHARE) is None


def test_the_ports_live_record_counts_each_launch():
    """The port's own record, as a traced ``run.py`` run reads it: two
    steps, each with an optimizer span of 7 trained elements inside which
    the counters move as one launch over 7 elements moves them (the
    kernel itself runs only on the card)."""
    from neuralnetworklibrary_tpu_torch.ops import adam
    from neuralnetworklibrary_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    try:
        for k in (1, 2):
            with tracing.span("learner.step", step=k):
                with tracing.span("learner.optimizer") as sp:
                    sp.data["elements"] = 7
                    adam.adam.launches += 1
                    adam.adam.elements += 7
    finally:
        tracing.disable()
    try:
        ctx = {"slice_steps": 2}
        assert harness.layer_metric(NAME).read(ctx) == 1.0
        assert harness.layer_metric(SHARE).read(ctx) == 100.0
    finally:
        tracing.reset()
