"""copy_ms_per_step.train: device milliseconds a step of the kernels that
cast or copy (``nn/transformer.py`` under autocast: dtype casts, layout
and concatenation copies), by kernel name, over the traced slice."""

from portbench import trace

NAMES = ("copy",)


def read(ctx):
    if not ctx["device_events"]:
        return None
    s = trace.seconds_of(ctx["device_events"], NAMES)
    return 1e3 * s / ctx["slice_steps"] if s > 0 else None
