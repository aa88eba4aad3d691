"""Host rANS milliseconds a megapixel: the codec's `stats` enc_rans_ms +
dec_z_rans_ms + dec_y_rans_ms, read after every call of the window and
summed, over the megapixels coded."""


def read(run):
    if run.kind != "codec" or not run.counters.get("mpix"):
        return None
    return run.counters["rans_ms"] / run.counters["mpix"]
