"""head_pad_launches_per_step.train: calls a step of the port's padded LM
head product (``ops/padded_head.py`` ``padded_head``): 1 where the
vocabulary leaves a bf16 row of the logits unaligned (GPT-2's 50,257), 0
where it does not (Qwen3's 151,936), from the port's counter as each
``learner.step`` span records it at its entry and exit, over the traced
slice's steps.  A port without that counter reads nothing."""

from portbench import spans

COUNTERS = ("padded_head.launches",)


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None or any(c not in s["counters_in"] for s in got[0]
                          if s["name"] == spans.STEP for c in COUNTERS):
        return None
    return spans.launches_per_step(ctx, COUNTERS)
