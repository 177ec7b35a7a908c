"""The two kinds of attention layer of a model that mixes them: sliding
window (a window > 0) and full.  The port's flash calls are the device
spans ``attention.sliding`` / ``attention.full`` and their ``.bwd``
spans, and count their attended (query, key) pairs of one head on the
device while tracing is on (``attention.sliding_pairs``,
``attention.full_pairs``, as each ``learner.step`` span records them at
its entry and exit).  The readers of both kinds take their numbers here;
a port without those spans or counters reads nothing.
"""

from __future__ import annotations

from portbench import roofline, spans


def ms_per_step(ctx, kind: str):
    """Device ms a step of the ``kind`` layers' attention, forward and
    backward."""
    return spans.device_ms_per_step(
        ctx, (f"attention.{kind}", f"attention.{kind}.bwd"))


def roofline_share(ctx, kind: str):
    """The ``kind`` layers' attention least time over its span time, in
    percent: ``roofline.attention_least_seconds`` of each such layer's
    call over its share of the counted pairs (the layers of a kind split
    a step's pairs evenly, as they see the same rows), at the dims' heads
    and widths."""
    counter = f"attention.{kind}_pairs"
    got = spans.of_slice(ctx)
    if got is None or any(counter not in s["counters_in"] for s in got[0]
                          if s["name"] == spans.STEP):
        return None
    measured = ms_per_step(ctx, kind)
    d = ctx["dims"]
    layers = sum((w > 0) == (kind == "sliding") for w in d["windows"])
    pairs = spans.launches_per_step(ctx, (counter,))
    if not measured or not layers or not pairs:
        return None
    least = layers * roofline.attention_least_seconds(
        pairs / layers, ctx["rows"], ctx["seq_len"], d["H"], d["Hkv"],
        d["hd"], d["separator"] is not None, ctx["dtype"])
    return 100.0 * least / (measured / 1e3)
