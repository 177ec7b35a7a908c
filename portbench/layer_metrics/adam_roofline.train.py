"""adam_roofline.train: the optimizer step's least time over its measured
time, in percent, over the traced slice.  The least time is Adam2's
bytes over the card's memory bandwidth: 28 bytes a trained element
(float32 parameter, m and v each read and written, the gradient read,
each once), the trained elements as the port's ``learner.optimizer``
span records them; the measured time is that span's device time."""

from portbench import roofline, spans

BYTES_PER_ELEMENT = 28


def read(ctx):
    got = spans.of_slice(ctx)
    if got is None:
        return None
    opt = [s for s in got[0] if s["name"] == "learner.optimizer"
           and s["device_ms"]]
    if not opt:
        return None
    least = sum(BYTES_PER_ELEMENT * s["elements"] for s in opt
                ) / roofline.HBM_BYTES_PER_S
    return 100.0 * least / sum(s["device_ms"] / 1e3 for s in opt)
