"""backward_ms_per_step.train: device milliseconds a step of the port's
``learner.backward`` span (``loss.backward()`` in ``Learner._step``,
between CUDA events the port records), over the traced slice's steps."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step(ctx, ("learner.backward",))
