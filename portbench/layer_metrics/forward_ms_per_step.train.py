"""forward_ms_per_step.train: device milliseconds a step of the port's
``learner.forward`` span (``Learner._step``: the input pipeline and the
model's forward under autocast, between CUDA events the port records),
over the traced slice's steps."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, ("learner.forward",))
