"""mfu.train: the whole step's share of the card's peak: model FLOPs of the
loss-bearing tokens of every step in the window (``roofline.model_flops``)
over the window's seconds times the configuration's compute peak, in
percent."""

from portbench import roofline


def read(ctx):
    peak = roofline.PEAK_FLOPS[ctx["dtype"]]
    return 100.0 * ctx["model_flops"] / (ctx["window_s"] * peak)
