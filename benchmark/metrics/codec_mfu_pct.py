"""The round trip's share of the card's FP32 peak: the operations of
g_a, h_a, h_s (once to encode, once to decode), g_s and their GDNs an
image (yardstick.layer_flops), times the images of the traced window,
against the window's length."""

from benchmark import yardstick


def read(run):
    peak = yardstick.peak(run.device_kind, "float32")
    if run.kind != "codec" or run.trace is None or not peak:
        return None
    flops = run.counters["flops_per_image"] * run.counters["images"]
    return 100 * flops / (run.trace.window_s * peak)
