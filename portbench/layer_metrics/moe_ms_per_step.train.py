"""moe_ms_per_step.train: device milliseconds a step in the port's expert
layers, forward and backward (``ops/moe.py``: the ``moe.router``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine`` spans and their
``.bwd`` spans, between CUDA events the port records), over the traced
slice's steps.  A port without expert layers reads nothing."""

from portbench import spans

PARTS = ("moe.router", "moe.dispatch", "moe.experts", "moe.combine")
NAMES = PARTS + tuple(p + ".bwd" for p in PARTS)


def read(ctx):
    return spans.device_ms_per_step(ctx, NAMES)
