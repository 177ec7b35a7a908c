"""From a ``torch.profiler`` trace of whole steps to what the per-layer
metrics read: the device's operations and their busy union, the idle
gaps with the host operation that ran during each, and the breakdown of
the result line.

Events are plain tuples, (name, start_s, end_s), so the arithmetic is
tested without a card.
"""

from __future__ import annotations

from collections import defaultdict

TOP = 10


def profiler_events(prof):
    """(device, host) events of a finished profiler: the device's kernels,
    copies and sets, and the host's operations and runtime calls, each
    (name, start_s, end_s) on the profiler's clock."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        tr = e.time_range
        if tr.end <= tr.start:
            continue
        row = (e.name, tr.start * 1e-6, tr.end * 1e-6)
        (device if e.device_type == DeviceType.CUDA else host).append(row)
    return device, host


def union(events):
    """Merged (start, end) intervals covered by the events."""
    out = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def seconds_of(events, patterns) -> float:
    """Summed durations of the device events whose names hold one of
    ``patterns`` (case-insensitive); copies and sets of memory, which are
    not kernels, are left out."""
    pats = tuple(p.lower() for p in patterns)
    total = 0.0
    for name, a, b in events:
        low = name.lower()
        if low.startswith(("memcpy", "memset")):
            continue
        if any(p in low for p in pats):
            total += b - a
    return total


def host_op_at(host, t):
    """Name of the innermost host event running at time t."""
    best = None
    for name, a, b in host:
        if a <= t <= b and (best is None or b - a < best[2] - best[1]):
            best = (name, a, b)
    return best[0] if best else "no host op"


def reduce(device, host) -> dict:
    """The traced slice: ``span_s`` from the first device event's start to
    the last one's end, ``busy_s`` the union of device events in it, and
    ``breakdown``: the device operations that took most time, and the
    longest idle gaps named by the host operation during each."""
    if not device:
        return {"span_s": 0.0, "busy_s": 0.0, "breakdown": None}
    merged = union(device)
    span = merged[-1][1] - merged[0][0]
    busy = sum(b - a for a, b in merged)
    by_name = defaultdict(float)
    for name, a, b in device:
        by_name[name] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(((b[0] - a[1], a[1], b[0])
                   for a, b in zip(merged, merged[1:])), reverse=True)[:TOP]
    idle = [[host_op_at(host, (g0 + g1) / 2), g] for g, g0, g1 in gaps]
    return {"span_s": span, "busy_s": busy,
            "breakdown": {"device_ops": [[n, s] for n, s in ops],
                          "idle_gaps": idle}}
