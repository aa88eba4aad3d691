"""The training step's share of the card's FP32 peak: the forward
operations of the cell's layers (convolutions, transposed convolutions,
GDN; yardstick.layer_flops) times three for forward and backward, over
the steps of the traced window, against the window's length."""

from benchmark import yardstick


def read(run):
    peak = yardstick.peak(run.device_kind, "float32")
    if run.kind != "train" or run.trace is None or not peak:
        return None
    flops = 3 * run.counters["fwd_flops"] * run.counters["steps"]
    return 100 * flops / (run.trace.window_s * peak)
