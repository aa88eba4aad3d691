"""Readings for the limits of a cell's comparison, on the card at the
cell's own size: the program's numbers on each seed, and the numbers of
the reference put in the program's place, computed in the nearest lower
precision (`tf32`: TF32 on, where the cells state f32 with TF32 off) or
with a fault planted (`half_batch`, `altered`; training cells).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        --variants program tf32 [--seconds 5]

One JSON line a seed and variant on standard output. `program` runs the
cell's set-up and, for a codec cell, a window of `--seconds` (long
enough to finish and sample its batches), then the comparison.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from run import ROOT, _environment


def main(argv=None) -> int:
    _environment()
    from benchmark import core

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--variants", nargs="+", default=["program", "tf32"])
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    cell = core.Cell(ROOT, args.workload)
    core.require_devices(cell.chips)
    for seed in args.seeds:
        drv = cell.driver().Driver(cell, seed, "cuda")
        for variant in args.variants:
            t0 = time.perf_counter()
            if variant == "program":
                drv.setup()
                if cell.kind == "codec":
                    drv.window(args.seconds, False)
                drv.release()
                t1 = time.perf_counter()
                got = drv.verify()
            else:
                t1 = time.perf_counter()
                got = drv.control(variant)
            got.pop("left_out", None)
            print(json.dumps({"seed": seed, "variant": variant, **got,
                              "program_s": t1 - t0,
                              "reference_s": time.perf_counter() - t1}),
                  flush=True)
    core.require_no_jax()
    return 0


if __name__ == "__main__":
    sys.exit(main())
