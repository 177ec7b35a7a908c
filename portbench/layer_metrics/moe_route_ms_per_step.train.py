"""moe_route_ms_per_step.train: device milliseconds a step of the expert
layers' routing, forward and backward: the port's ``moe.router`` (the
float32 router product, softmax and top-k), ``moe.dispatch`` (the sort by
expert and the gather of the rows) and ``moe.combine`` (each token's sum
of its held slots) spans and their ``.bwd`` spans, over the traced
slice's steps: the memory- and latency-bound part, without the grouped
products."""

from portbench import spans

PARTS = ("moe.router", "moe.dispatch", "moe.combine")
NAMES = PARTS + tuple(p + ".bwd" for p in PARTS)


def read(ctx):
    return spans.device_ms_per_step(ctx, NAMES)
