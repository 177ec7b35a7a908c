"""attention_idle_ms_per_step.train: device idle milliseconds a step of the
traced slice whose gap's middle falls while one of the port's
``attention.*`` spans is open, by the profiler's host events (``nnl/``
ranges, on any thread).  It needs those events in ``ctx["host_events"]``
(``spans.py``'s run passes them) and finds nothing without them."""

from portbench import spans


def read(ctx):
    if "host_events" not in ctx or spans.recorded(ctx) is None:
        return None
    idle = spans.idle_by_span(ctx["device_events"], ctx["host_events"])
    return 1e3 * sum(v for k, v in idle.items()
                     if k.startswith("attention.")) / ctx["slice_steps"]
