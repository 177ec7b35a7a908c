"""attn_sliding_ms_per_step.train: device milliseconds a step of the port's
sliding attention layers' flash calls, forward and backward (the
``attention.sliding`` and ``attention.sliding.bwd`` spans of
``ops/flash_attention.py``, between CUDA events the port records), over
the traced slice's steps.  A port without those spans reads nothing."""

from portbench import attention_kinds


def read(ctx):
    return attention_kinds.ms_per_step(ctx, "sliding")
