"""moe_gemm_roofline.train: the expert products' least time over their
measured time, in percent, over the traced slice.  The least time is
that of the held assignments' gate, up and down products, forward, dX
and dW (``moe_roofline.expert_least_seconds``), the assignments counted
by the port on the device (``moe_experts.assignments``, as each
``learner.step`` span records it at its entry and exit); the measured
time is the device time of the port's ``moe.experts`` and
``moe.experts.bwd`` spans (the grouped products and the activation
between them).  A port without that counter reads nothing."""

from portbench import moe_roofline, spans

COUNTER = "moe_experts.assignments"
NAMES = ("moe.experts", "moe.experts.bwd")


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None or any(COUNTER not in s["counters_in"] for s in got[0]
                          if s["name"] == spans.STEP):
        return None
    measured = spans.device_ms_per_step(ctx, NAMES)
    if not measured:
        return None
    d = ctx["dims"]
    held = spans.launches_per_step(ctx, (COUNTER,))
    least = moe_roofline.expert_least_seconds(
        held, d["L"], d["moe_held"], d["D"], d["moe_ff"], ctx["dtype"])
    return 100.0 * least / (measured / 1e3)
