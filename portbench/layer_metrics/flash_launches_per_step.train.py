"""flash_launches_per_step.train: launches a step of the port's flash
attention kernels (K1 ``flash_fwd``, K2 ``flash_bwd_dq``, K3
``flash_bwd_dkv``, K4 ``flash_bwd_dbias``), from the port's own launch
counters as each ``learner.step`` span records them at its entry and
exit, over the traced slice's steps."""

from portbench import spans

COUNTERS = ("flash_fwd.launches", "flash_bwd_dq.launches",
            "flash_bwd_dkv.launches", "flash_bwd_dbias.launches")


def read(ctx):
    return spans.launches_per_step(ctx, COUNTERS)
