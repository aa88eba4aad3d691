"""Run one cell of lmic_tpu_torch's benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the CUDA devices the cell
asks for. It makes the cell's weights and inputs from the seed, builds
and warms up the program (lmic_tpu_torch) through its normal entry
points, measures for `--seconds`, compares what the window produced
with the plain reference in benchmark/reference/, and prints as its last
line on standard output one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics with `--trace 0`, its
per-layer metrics with `--trace 1`), `device`, with `--trace 1`
`breakdown`, and last `checks`, each number compared beside its limit
(also the last lines on standard error). Without the devices, or with
jax, jaxlib, flax or lmic_tpu loaded, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment():
    """Build and kernel caches at fixed paths inside the checkout; no
    library may bring JAX in."""
    cache = os.path.join(ROOT, "_bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, counts=None, root=ROOT) -> int:
    """`device`, `counts` and `root` are for the CPU tests: they skip the
    look for a card, count GDN launches another way, and read the cell
    from another copy of the benchmark's files."""
    _environment()
    from benchmark import core

    clock = core.Clock()
    args = parse(argv)
    cell = core.Cell(root, args.workload)
    if device is None:
        core.require_devices(cell.chips)
        device = "cuda"
    import torch

    from benchmark.run_record import Run

    kw = {} if counts is None else {"counts": counts}
    drv = cell.driver().Driver(cell, args.seed, device, **kw)
    drv.setup()
    setup_s = clock.since_start()
    trace = bool(args.trace)
    e2e, counters, summary, window_s = drv.window(args.seconds, trace)
    on_card = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    drv.release()
    readings = drv.verify()
    checks, correct = core.check_entries(readings, cell.limits)
    device_out = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        run = Run(cell.kind, kind, window_s, counters, summary)
        metrics = core.read_per_layer(cell, run)
        if summary is not None:
            device_out["busy_s"] = summary.busy_s
            device_out["window_s"] = summary.window_s
            breakdown = {"device_ops": summary.top_kernels(),
                         "idle_gaps": summary.top_gaps()}
    else:
        values = {**e2e, "setup_s": setup_s}
        missing = [m["name"] for m in cell.end_to_end
                   if m["name"] not in values]
        if missing:
            raise KeyError(f"the {cell.kind} driver gives no {missing}")
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    core.require_no_jax()
    line = core.result_line(correct, drv.attempted, drv.failed, metrics,
                            device_out, checks, breakdown)
    sys.stdout.write(line + "\n")
    sys.stdout.flush()
    for name, value, limit in checks:
        sys.stderr.write(f"{name} {value!r} limit {limit!r}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
