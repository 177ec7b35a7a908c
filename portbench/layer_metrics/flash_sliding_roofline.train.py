"""flash_sliding_roofline.train: the sliding attention layers' least time
over their measured time, in percent, over the traced slice.  The least
time is ``roofline.attention_least_seconds`` of each such layer's call
over the attended pairs the port counts on the device
(``attention.sliding_pairs``); the measured time is that of
``attn_sliding_ms_per_step.train``'s spans.  A port without that counter
reads nothing."""

from portbench import attention_kinds


def read(ctx):
    return attention_kinds.roofline_share(ctx, "sliding")
