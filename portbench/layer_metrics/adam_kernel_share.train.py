"""adam_kernel_share.train: the share of the trained elements that the
port's fused Adam kernel (``ops/adam.py`` ``adam``) updated, in percent,
over the traced slice: the increase of the port's ``adam.elements``
counter over the slice's ``learner.step`` spans, over the trained
elements their ``learner.optimizer`` spans record.  100 where every
trained leaf goes through the kernel; 0 where the foreach chain runs the
step.  A port without that counter reads nothing."""

from portbench import spans

COUNTER = "adam.elements"


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None:
        return None
    steps = [s for s in got[0] if s["name"] == spans.STEP]
    trained = sum(s.get("elements") or 0 for s in got[0]
                  if s["name"] == "learner.optimizer")
    if not trained or any(COUNTER not in s["counters_in"] for s in steps):
        return None
    return 100.0 * sum(s["counters_out"][COUNTER] - s["counters_in"][COUNTER]
                       for s in steps) / trained
