"""head_ce_ms_per_step.train: device milliseconds a step of the LM head and
its loss, forward and backward, over the traced slice's steps: the
port's ``lm.head`` span (``TransformerLM.forward``'s head product) and
``learner.loss`` span (the float32 cast and the cross-entropy), and the
backward from its start to the ``lm.head.grad`` mark, which the port
records when the head's input has its gradient (the CE's backward, the
cast's and the head's, dX and the tied dW, are then done)."""

from portbench import spans

NAMES = ("lm.head", "learner.loss", "lm.head.grad")


def read(ctx):
    return spans.device_ms_per_step(ctx, NAMES)
