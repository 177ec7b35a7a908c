"""device_idle.train: the share of the traced slice, from its first device
operation's start to its last one's end, in which no operation ran on the
device, in percent."""


def read(ctx):
    if ctx["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["span_s"])
