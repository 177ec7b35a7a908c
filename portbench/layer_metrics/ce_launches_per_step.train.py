"""ce_launches_per_step.train: launches a step of the port's cross-entropy
kernels (``ops/cross_entropy.py`` ``cross_entropy``): 2 where the step's
loss takes each row's CE through them (the forward pass and the backward
pass), 0 where it does not, from the port's counter as each
``learner.step`` span records it at its entry and exit, over the traced
slice's steps.  A port without that counter reads nothing."""

from portbench import spans

COUNTERS = ("cross_entropy.launches",)


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None or any(c not in s["counters_in"] for s in got[0]
                          if s["name"] == spans.STEP for c in COUNTERS):
        return None
    return spans.launches_per_step(ctx, COUNTERS)
