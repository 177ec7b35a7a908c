"""The reader of the port's K3 tile counters,
``flash_dkv_tile_share.train``: the query tiles K3 visited over those of
the whole causal range, in percent, across the slice's steps; nothing
(no error) on a port that has no such counters, as the parent of the
change that added them has not, or on a slice with no K3 launch on the
options' path."""

import pytest

from portbench import harness

NAME = "flash_dkv_tile_share.train"
VISITED = "flash_bwd_dkv.query_tiles"
CAUSAL = "flash_bwd_dkv.causal_query_tiles"


def _run(n_steps=6, visited=53, causal=100, counter=True):
    """Records of ``n_steps`` steps whose counters rise by ``visited``
    and ``causal`` tiles each."""
    recs, count = [], {"flash_bwd_dkv.launches": 0}
    if counter:
        count[VISITED] = count[CAUSAL] = 0
    for k in range(1, n_steps + 1):
        before = dict(count)
        count["flash_bwd_dkv.launches"] += 28
        if counter:
            count[VISITED] += visited
            count[CAUSAL] += causal
        t = 10_000 * k
        recs.append({"name": "learner.step", "id": k, "parent": None,
                     "step": k, "thread": 1, "start_ns": t,
                     "end_ns": t + 100, "self_ns": 100, "device_ms": None,
                     "counters_in": before, "counters_out": dict(count)})
    return {"spans": recs, "counters": count}


def _read(run):
    return harness.layer_metric(NAME).read({"spans": run, "slice_steps": 4})


@pytest.mark.parametrize("visited, causal, want", [
    (100, 100, 100.0), (53, 100, 53.0), (0, 40, 0.0)])
def test_the_share_of_the_causal_tiles_visited(visited, causal, want):
    assert _read(_run(visited=visited, causal=causal)) == want


def test_only_the_slices_steps_count():
    run = _run(visited=50, causal=100)
    first = run["spans"][0]
    first["counters_out"] = {**first["counters_out"], VISITED: 99,
                             CAUSAL: 100}
    assert _read(run) == 50.0


def test_a_port_without_the_counters_reads_nothing():
    assert _read(_run(counter=False)) is None


def test_a_run_without_spans_reads_nothing():
    assert _read({"spans": [], "counters": {}}) is None


def test_a_slice_without_options_launches_reads_nothing():
    assert _read(_run(visited=0, causal=0)) is None


def test_the_ports_live_record_reads_the_share():
    """The port's own record, as a traced ``run.py`` run reads it: two
    steps inside which the device counter rises as K3 adds to it (the
    kernel itself runs only on the card)."""
    import torch

    from neuralnetworklibrary_tpu_torch.ops import flash_attention as fa
    from neuralnetworklibrary_tpu_torch.utils import tracing

    saved = fa._tiles[0]
    fa._tiles[0] = torch.zeros(2, dtype=torch.int64)
    tracing.reset()
    tracing.enable()
    try:
        for k in (1, 2):
            with tracing.span("learner.step", step=k):
                fa._tiles[0].add_(torch.tensor([3, 4]))
    finally:
        tracing.disable()
    try:
        assert harness.layer_metric(NAME).read({"slice_steps": 2}) == 75.0
    finally:
        tracing.reset()
        fa._tiles[0] = saved
