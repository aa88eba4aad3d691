"""The share of the traced window in which no operation ran on the card
(torch.profiler's device records, their union), in the train cells."""


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    return 100 * (1 - run.trace.busy_s / run.trace.window_s)
