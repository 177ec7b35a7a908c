"""optimizer_ms_per_step.train: device milliseconds between CUDA events
recorded around ``learner.optimizer.apply`` (``core/optim.py``, foreach
Adam2) in each step of the traced slice, averaged."""


def read(ctx):
    s = ctx["optimizer_s"]
    return 1e3 * sum(s) / len(s) if s else None
