"""The readers of the port's spans and counters, against hand-built records
and events with the values worked out one by one, and the idle-by-span
arithmetic on tuples."""

import pytest

from portbench import harness, spans

FLASH = ("flash_fwd.launches", "flash_bwd_dq.launches",
         "flash_bwd_dkv.launches", "flash_bwd_dbias.launches")
OTHER = ("lstm_fwd.launches", "lstm_bwd.launches",
         "paged_attention.launches")
ELEMENTS = 1_000_000


def _rec(ids, name, parent, step, start, end, self_ns=None, device_ms=None,
         **data):
    i = next(ids)
    return {"name": name, "id": i, "parent": parent, "step": step,
            "thread": 1, "start_ns": start, "end_ns": end,
            "self_ns": end - start if self_ns is None else self_ns,
            "device_ms": device_ms, **data}


def _run(n_steps=6):
    """Records of set-up and ``n_steps`` steps; every number differs by
    step so that a wrong step or a wrong span shows."""
    ids = iter(range(1, 10_000))
    recs = []
    q = _rec(ids, "convert.load_qwen3", None, 0, 0, 3_000_000_000)
    recs += [q, _rec(ids, "convert.load_jax_params", q["id"], 0,
                     1_000_000_000, 2_500_000_000),
             _rec(ids, "loader.next", None, 0, 3_100_000_000,
                  3_200_000_000)]
    count = dict.fromkeys(FLASH + OTHER, 0)
    for k in range(1, n_steps + 1):
        t = 10_000_000_000 * k
        before = dict(count)
        for c in FLASH[:3]:
            count[c] += 28 + k          # K1-K3, one a layer, and k more
        count["lstm_fwd.launches"] += 5
        step = _rec(ids, "learner.step", None, k, t, t + 400_000_000,
                    counters_in=before, counters_out=dict(count))
        sid = step["id"]
        fwd = _rec(ids, "learner.forward", sid, k, t + 1, t + 100,
                   device_ms=100.0 + k)
        bwd = _rec(ids, "learner.backward", sid, k, t + 200, t + 300,
                   device_ms=200.0 + k)
        recs += [step, fwd, bwd,
                 _rec(ids, "lm.head", fwd["id"], k, t + 90, t + 99,
                      device_ms=10.0 + k),
                 _rec(ids, "learner.loss", sid, k, t + 100, t + 200,
                      device_ms=20.0 + k),
                 _rec(ids, "lm.head.grad", bwd["id"], k, t + 210, t + 210,
                      device_ms=30.0 + k, mark=True),
                 _rec(ids, "learner.optimizer", sid, k, t + 300, t + 310,
                      device_ms=4.0 + k, elements=ELEMENTS + k),
                 _rec(ids, "learner.h2d", sid, k, t, t + 1, self_ns=7),
                 _rec(ids, "loader.next", None, k, t - 5, t - 1)]
        for j in range(2):
            recs += [_rec(ids, "attention.fwd", fwd["id"], k, t + 2, t + 9,
                          self_ns=1_000_000 * k + j),
                     _rec(ids, "attention.bwd", bwd["id"], k, t + 220,
                          t + 230, self_ns=3_000_000 * k + j)]
    return {"spans": recs, "counters": count}


def _ctx(**kw):
    return {"spans": _run(), "slice_steps": 4, **kw}


SLICE = (3, 4, 5, 6)


def _read(name, ctx):
    return harness.layer_metric(name).read(ctx)


@pytest.mark.parametrize("name, want", [
    ("forward_ms_per_step.train", sum(100.0 + k for k in SLICE) / 4),
    ("backward_ms_per_step.train", sum(200.0 + k for k in SLICE) / 4),
    ("head_ce_ms_per_step.train",
     sum(10.0 + k + 20.0 + k + 30.0 + k for k in SLICE) / 4),
    ("attention_host_ms_per_step.train",
     sum(2 * (1e6 * k + 3e6 * k) + 2 for k in SLICE) / 1e6 / 4),
    ("flash_launches_per_step.train", sum(3 * (28 + k) for k in SLICE) / 4),
    ("adam_roofline.train",
     100.0 * sum(28 * (ELEMENTS + k) / 3.35e12 for k in SLICE)
     / sum((4.0 + k) / 1e3 for k in SLICE)),
    ("convert_s.setup", 3.0),
])
def test_each_span_reader_against_the_records(name, want):
    assert _read(name, _ctx()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", [
    "forward_ms_per_step.train", "backward_ms_per_step.train",
    "head_ce_ms_per_step.train", "adam_roofline.train",
    "attention_host_ms_per_step.train", "flash_launches_per_step.train",
    "attention_idle_ms_per_step.train", "convert_s.setup"])
def test_a_run_without_spans_reads_nothing(name):
    ctx = {"spans": {"spans": [], "counters": {}}, "slice_steps": 4,
           "device_events": [("k", 0.0, 1.0)], "host_events": []}
    assert _read(name, ctx) is None


def test_spans_present_with_nothing_in_them_read_zero():
    run = _run()
    run["spans"] = [s for s in run["spans"]
                    if not s["name"].startswith(("attention.", "convert."))]
    ctx = {"spans": run, "slice_steps": 4,
           "device_events": [("k", 0.0, 1.0), ("k", 2.0, 3.0)],
           "host_events": [("nnl/learner.forward", 0.0, 3.0)]}
    assert _read("attention_host_ms_per_step.train", ctx) == 0.0
    assert _read("attention_idle_ms_per_step.train", ctx) == 0.0
    assert _read("convert_s.setup", ctx) == 0.0


# device busy [0, 1], [2, 3], [5, 6], [6.5, 7]: gaps (1, 2), (3, 5),
# (6, 6.5); the backward's range on the step's thread holds the first two
# gaps, an attention range on autograd's thread the middle of the second
DEVICE = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k2", 2.5, 2.9),
          ("k3", 5.0, 6.0), ("k4", 6.5, 7.0)]
HOST = [("nnl/learner.step", 0.0, 6.0), ("nnl/learner.backward", 0.5, 5.5),
        ("aten::mm", 1.0, 2.0), ("nnl/attention.bwd", 3.5, 4.5),
        ("cudaStreamSynchronize", 4.0, 4.2), ("cudaMemcpyAsync", 1.4, 1.6),
        ("cudaDeviceSynchronize", 6.9, 7.0)]


def test_idle_by_span_names_each_gap_by_the_innermost_port_span():
    got = spans.idle_by_span(DEVICE, HOST)
    assert got == pytest.approx({"learner.backward": 1.0,
                                 "attention.bwd": 2.0, "none": 0.5})


def test_attention_idle_reads_the_gaps_under_attention():
    ctx = _ctx(device_events=DEVICE, host_events=HOST)
    assert _read("attention_idle_ms_per_step.train", ctx) == pytest.approx(
        1e3 * 2.0 / 4)


def test_the_spans_summary_of_a_line():
    ctx = _ctx(device_events=DEVICE, host_events=HOST)
    got = spans.summary(ctx)
    assert sum(got["idle_ms"].values()) == pytest.approx(1e3 * 3.5 / 4)
    assert got["syncs"] == pytest.approx({"attention.bwd": 0.25,
                                          "none": 0.25})
    assert got["setup_s"] == pytest.approx({"convert.load_qwen3": 3.0,
                                            "convert.load_jax_params": 1.5})
    assert got["device_ms"]["learner.forward"] == pytest.approx(
        sum(100.0 + k for k in SLICE) / 4)
    assert got["host_self_ms"]["learner.h2d"] == pytest.approx(7 / 1e6)
    assert len(got["host_self_ms"]) <= 10 and len(got["device_ms"]) <= 10


def test_the_readers_take_the_ports_live_record():
    """Without ``ctx["spans"]`` the readers read the port's own record, as
    in a traced run of ``run.py``."""
    from neuralnetworklibrary_tpu_torch.utils import tracing

    tracing.reset()
    tracing.enable()
    try:
        for k in (1, 2):
            with tracing.span("learner.step", step=k):
                with tracing.span("attention.fwd"):
                    pass
    finally:
        tracing.disable()
    ctx = {"slice_steps": 1}
    try:
        assert _read("attention_host_ms_per_step.train", ctx) > 0
        assert _read("flash_launches_per_step.train", ctx) == 0.0
        assert _read("forward_ms_per_step.train", ctx) is None
        assert _read("convert_s.setup", ctx) is None
    finally:
        tracing.reset()
