"""adam_launches_per_step.train: launches a step of the port's fused Adam
kernel (``ops/adam.py`` ``adam``): one for each (layer group, step count)
set of the trained leaves, more where a set holds more tensors than one
launch's table, 0 where the foreach chain runs the step; from the
port's counter as each ``learner.step`` span records it at its entry and
exit, over the traced slice's steps.  A port without that counter reads
nothing."""

from portbench import spans

COUNTERS = ("adam.launches",)


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None or any(c not in s["counters_in"] for s in got[0]
                          if s["name"] == spans.STEP for c in COUNTERS):
        return None
    return spans.launches_per_step(ctx, COUNTERS)
