"""The GDN kernels' roofline share of a traced window (read by the
`gdn_roofline.*` metrics)."""

from benchmark import launches, yardstick


def share(run):
    if run.trace is None:
        return None
    flops = yardstick.peak(run.device_kind, "float32")
    bw = yardstick.peak(run.device_kind, "bytes_per_s")
    if not flops or not bw:
        return None
    c = run.counters
    # every launch of the window: a step's (or a batch's) GDN layers, each
    # launching once per class that its kind of cell runs
    per = run.kind == "train" and list(yardstick.GDN_COSTS) or ["gdn_fwd"]
    units = c["steps"] if run.kind == "train" else c["batches"]
    bound = units * sum(
        yardstick.bound_s(yardstick.GDN_COSTS[cls](rows, C), flops, bw)
        for _, C, rows in c["gdn_layers"] for cls in per)
    spent = launches.scaled_seconds(run.trace.kernels, c["gdn_launches"])
    if not spent:
        return None
    return 100 * bound / spent
