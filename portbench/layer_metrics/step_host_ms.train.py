"""step_host_ms.train: host milliseconds inside each
``Learner.train1minibatch`` call of the traced slice (the benchmark's own
span, no sync), averaged.  Near the device's time per step, the host is
held back by the full launch queue; far under it, the host has room."""


def read(ctx):
    s = ctx["host_step_s"]
    return 1e3 * sum(s) / len(s) if s else None
