"""The port's own spans and counters (``utils/tracing.py`` of the port) as
the per-layer metrics read them, and a run of a cell with tracing on from
its start.

The port records its spans while a ``torch.profiler`` session records, so
the traced slice of every ``run.py --trace 1`` run leaves its steps' spans
in the port, where the readers take them (:func:`recorded`).  A run
without them (a port that has no tracing) gives the readers nothing, and
they return None.  Spans are dicts as ``tracing.snapshot()`` gives them;
profiler events are (name, start_s, end_s) tuples, as ``trace.py`` gives
them, so the arithmetic is tested without a card.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does, with the port's tracing on
from the start, so set-up's converters and every step are recorded, and
keeps the profiler's host events.  Its line adds the metrics that need
them (:data:`RUN_ONLY`) and ``spans``: per step of the slice, host self
ms by span, device ms by device span, device idle ms by the innermost
port span open at each gap's middle (``none`` where none was), and the
synchronizing calls by span; and set-up seconds by converter.
"""

from __future__ import annotations

import os
import sys
import time
from collections import defaultdict

from portbench import trace

STEP = "learner.step"
PREFIX = "nnl/"
# the runtime calls that wait for the device
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
TOP = 10
# readers that need the host events or set-up's spans, and their units
RUN_ONLY = {"attention_idle_ms_per_step.train": "ms", "convert_s.setup": "s"}


def recorded(ctx):
    """The run's spans: ``ctx["spans"]`` where the run passed them, else
    the port's own record; None where there is no record or it is
    empty."""
    snap = ctx.get("spans")
    if snap is None:
        try:
            from neuralnetworklibrary_tpu_torch.utils import tracing
        except ImportError:
            return None
        snap = tracing.snapshot()
    return snap if snap["spans"] else None


def of_slice(ctx):
    """(the spans of the slice's steps, the number of steps): the last
    ``ctx["slice_steps"]`` steps recorded; None where none was."""
    snap = recorded(ctx)
    if snap is None:
        return None
    ids = sorted({s["step"] for s in snap["spans"] if s["name"] == STEP})
    ids = set(ids[-ctx["slice_steps"]:])
    if not ids:
        return None
    return [s for s in snap["spans"] if s["step"] in ids], len(ids)


def device_ms_per_step(ctx, names):
    """Device ms a step of the spans and marks named ``names``; None where
    none of them carries device time."""
    got = of_slice(ctx)
    if got is None:
        return None
    timed = [s["device_ms"] for s in got[0]
             if s["name"] in names and s["device_ms"] is not None]
    return sum(timed) / got[1] if timed else None


def launches_per_step(ctx, counters):
    """The increase of ``counters`` over the slice's step spans, a step."""
    got = of_slice(ctx)
    if got is None:
        return None
    steps = [s for s in got[0] if s["name"] == STEP]
    return sum(s["counters_out"][c] - s["counters_in"][c]
               for s in steps for c in counters) / got[1]


def idle_by_span(device, host) -> dict:
    """Seconds of device idle by the innermost port span (the shortest
    ``nnl/`` host event, on any thread) open at each gap's middle
    (``"none"`` where none was)."""
    port = [e for e in host if e[0].startswith(PREFIX)]
    merged = trace.union(device)
    out = defaultdict(float)
    for (_, a), (b, _) in zip(merged, merged[1:]):
        out[_span_at(port, (a + b) / 2)] += b - a
    return dict(out)


def _span_at(port, t):
    name = trace.host_op_at(port, t)
    return name[len(PREFIX):] if name.startswith(PREFIX) else "none"


def _top(d, n=TOP):
    return dict(sorted(d.items(), key=lambda kv: -kv[1])[:n])


def summary(ctx) -> dict:
    """The ``spans`` entry of a line: per step of the slice, host self ms
    and device ms by span, idle ms by innermost port span, synchronizing
    calls by span; set-up seconds by converter."""
    spans, n = of_slice(ctx)
    host_ms, dev_ms, syncs = (defaultdict(float) for _ in "abc")
    for s in spans:
        host_ms[s["name"]] += s["self_ns"] / 1e6 / n
        if s["device_ms"] is not None:
            dev_ms[s["name"]] += s["device_ms"] / n
    port = [e for e in ctx["host_events"] if e[0].startswith(PREFIX)]
    for name, a, b in ctx["host_events"]:
        if name in SYNCS:
            syncs[_span_at(port, (a + b) / 2)] += 1 / n
    idle = idle_by_span(ctx["device_events"], ctx["host_events"])
    setup = defaultdict(float)
    for s in recorded(ctx)["spans"]:
        if s["name"].startswith("convert.") and s["step"] == 0:
            setup[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
    return {"host_self_ms": _top(host_ms), "device_ms": _top(dev_ms),
            "idle_ms": {k: 1e3 * v / n for k, v in _top(idle, None).items()},
            "syncs": _top(syncs), "setup_s": dict(setup)}


def main(argv, t_start: float) -> int:
    import argparse
    import json

    import torch

    from neuralnetworklibrary_tpu_torch.utils import tracing
    from portbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    spec = harness.resolve(args.workload, harness.manifest())
    if torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"portbench: {args.workload} needs "
              f"{spec['cell']['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    kept, read = {}, trace.profiler_events

    def keep(prof):
        kept["device"], kept["host"] = read(prof)
        return kept["device"], kept["host"]

    trace.profiler_events = keep   # the harness's own reading, kept
    tracing.enable()
    try:
        res = harness.run(spec, args.seed, args.seconds, True, "cuda",
                          t_start)
    finally:
        trace.profiler_events = read
        tracing.disable()
    ctx = {"spans": tracing.snapshot(), "device_events": kept["device"],
           "host_events": kept["host"], "slice_steps": harness.SLICE_STEPS}
    tracing.reset()
    for name, unit in RUN_ONLY.items():
        value = harness.layer_metric(name).read(ctx)
        if value is not None:
            res["metrics"][name] = {"value": value, "unit": unit}
    checks = res.pop("checks")
    res["spans"] = summary(ctx)
    res["checks"] = checks
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package loaded: {bad}",
              file=sys.stderr)
        return 3
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    T_START = time.perf_counter()
    # libraries that would load JAX by themselves are kept from it
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_TF", "0")
    sys.exit(main(sys.argv[1:], T_START))
