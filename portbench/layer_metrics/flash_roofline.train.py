"""flash_roofline.train: the attention call's least time over its kernels'
measured time, in percent, over the traced slice.  The least time is that
of the work these inputs need in every layer's attention forward and
backward (``roofline.attention_least_seconds`` over the slice's attended
pairs); the measured time is that of the kernels
``flash_ms_per_step.train`` reads."""

from portbench import roofline, trace

NAMES = ("flash_fwd", "flash_bwd", "flash_dbias")   # as flash_ms_per_step


def read(ctx):
    measured = trace.seconds_of(ctx["device_events"], NAMES)
    if measured <= 0:
        return None
    d = ctx["dims"]
    least = d["L"] * sum(roofline.attention_least_seconds(
        pairs, ctx["rows"], ctx["seq_len"], d["H"], d["Hkv"], d["hd"],
        d["separator"] is not None, ctx["dtype"]) for pairs in ctx["pairs"])
    return 100.0 * least / measured
