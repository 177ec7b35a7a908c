"""attention_host_ms_per_step.train: host milliseconds a step inside the
port's attention calls, on every thread, over the traced slice's steps:
the self time of its ``attention.fwd`` spans (``flash_attention``, from
its checks through the K1 launch) and ``attention.bwd`` spans
(``_FlashAttention.backward``: delta, K2, K3, dsink).  A launch that
waits on a full queue counts, as in ``step_host_ms.train``."""

from portbench import spans

NAMES = ("attention.fwd", "attention.bwd")


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None:
        return None
    return sum(s["self_ns"] for s in got[0] if s["name"] in NAMES
               ) / 1e6 / got[1]
