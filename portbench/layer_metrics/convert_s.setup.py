"""convert_s.setup: host seconds of set-up inside the port's converters
(``convert.load_qwen3``, ``convert.load_jax_params``; a converter called
by another counts once), before the first step.  It needs a record of
set-up, which a run with tracing on from its start passes in
``ctx["spans"]`` (``spans.py``'s run), and finds nothing without it."""

from portbench import spans


def read(ctx):
    if "spans" not in ctx or spans.recorded(ctx) is None:
        return None
    recs = ctx["spans"]["spans"]
    convert = {s["id"] for s in recs if s["name"].startswith("convert.")}
    return sum(s["end_ns"] - s["start_ns"] for s in recs
               if s["id"] in convert and s["parent"] not in convert
               and s["step"] == 0) / 1e9
