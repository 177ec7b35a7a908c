"""flash_ms_per_step.train: device milliseconds a step of the port's flash
attention kernels (``csrc/flash_attention.cu``: K1 ``flash_fwd*``, K2
``flash_bwd_dq*``, K3 ``flash_bwd_dkv*``, K4 ``flash_dbias*``), by kernel
name, over the traced slice."""

from portbench import trace

NAMES = ("flash_fwd", "flash_bwd", "flash_dbias")


def read(ctx):
    s = trace.seconds_of(ctx["device_events"], NAMES)
    return 1e3 * s / ctx["slice_steps"] if s > 0 else None
