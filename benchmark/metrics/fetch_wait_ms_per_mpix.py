"""Milliseconds the host waited on the card's results a megapixel: the
codec's `stats` enc_fetch_ms + dec_idx_fetch_ms + dec_fetch_ms, read
after every call of the window and summed, over the megapixels coded."""


def read(run):
    if run.kind != "codec" or not run.counters.get("mpix"):
        return None
    return run.counters["fetch_ms"] / run.counters["mpix"]
