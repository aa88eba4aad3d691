#!/usr/bin/env python3
"""One-off measurements on one GPU behind numbers in PERF.md, kept apart
from `chip_smoke.py` (whose helpers they use) because no path of the port
runs them.

    python3 chip_probes.py master-batch [B ...]  # from the root of a checkout
    python3 chip_probes.py train-convs

- master-batch: the largest batch of the RGB-T master's training step
  that fits, the channel-1 master q7 (f32) against its frozen guided q7 on
  512x640 thermal masters with 1024x1280 RGB guides, as `chip_smoke.py`'s
  phase 8 runs it: two steps at each batch (default 4 6 8 10 12 16),
  ascending, until one runs out of memory; each batch's step ms and peak
  memory.
- train-convs: a 3x3 conv forward and backward under autograd, f32, TF32
  off, deterministic, at the training shapes `chip_smoke.py` logs (192 ->
  192 at 128x128, batch 16; 256 -> 256 at 512x640, batch 4), through
  cuDNN's heuristic pick (the training step's route), cuDNN's timed pick
  among its deterministic algorithms (`benchmark`), and, at the first
  shape, im2col + one cuBLAS product with autograd's fold
  (`layers._conv_gemm`): device ms, device operations, FFT kernels.
"""

from __future__ import annotations

import json
import sys
import time

import chip_smoke
from chip_smoke import (
    LAMBDAS,
    MASTER_BATCH,
    MASTER_GUIDE,
    RGBT_QUALITY,
    _fft_kernels,
    _profile,
    _time_ms,
    _train_batch,
    log,
)


def master_batch(batches):
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.train import create_train_state, make_optimizer
    from lmic_tpu_torch.utils.train_cli import make_master_train_step

    q = RGBT_QUALITY
    guided = zoo.create_model("guided", q, seed=0, channel=3,
                              first_stride=2, device="cuda").module
    guided.eval().requires_grad_(False)
    master = zoo.create_model("master", q, seed=1, channel=1,
                              device="cuda").module
    opt = make_optimizer()
    state = create_train_state(master, opt)
    step = make_master_train_step(master, guided, opt, LAMBDAS[q - 1])
    fits = None
    for b in batches:
        try:
            xm = _train_batch((b, *MASTER_BATCH[1:]), seed=3)
            xg = _train_batch((b, *MASTER_GUIDE[1:]), seed=4)
            torch.cuda.reset_peak_memory_stats()
            step(state, xm, xg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, xm, xg)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        except torch.cuda.OutOfMemoryError as e:
            log(f"master batch {b}: out of memory ({str(e).splitlines()[0]})")
            break
        finally:
            xm = xg = None
            state.main.zero_grad(set_to_none=True)
            state.aux.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        fits = b
        log(f"master batch {b}: step {ms:.1f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}")
    log(f"largest master batch that fits: {fits} (of {list(batches)})")


def train_convs():
    import torch
    import torch.nn.functional as F

    from lmic_tpu_torch.layers.layers import _conv_gemm

    gen = torch.Generator(device="cuda").manual_seed(0)
    for B, C, H, W in ((16, 192, 128, 128), (4, 256, 512, 640)):
        x = torch.randn((B, C, H, W), generator=gen, device="cuda")
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
        w = (torch.randn((C, C, 3, 3), generator=gen, device="cuda")
             / (3 * C ** 0.5)).requires_grad_()
        b = torch.zeros(C, device="cuda", requires_grad=True)
        g = torch.randn((B, C, H, W), generator=gen, device="cuda")
        routes = {"cudnn": lambda: F.conv2d(x, w, b, padding=1)}
        routes["cudnn_benchmark"] = routes["cudnn"]
        if C == 192:
            routes["gemm_route"] = lambda: _conv_gemm(x, w, b, (1, 1))
        out = {}
        for route, conv in routes.items():
            def run():
                torch.autograd.backward(conv(), g)

            with torch.backends.cudnn.flags(
                    enabled=True, benchmark=route == "cudnn_benchmark",
                    deterministic=True, allow_tf32=False):
                ms = _time_ms(run, runs=3, warmup=1)
                _, _, _, kernels, ops = _profile(run, n=1, keep=None)
            out[route] = {"ms": round(ms, 2), "device_operations": ops,
                          "fft_kernels": len(_fft_kernels(kernels))}
        log(f"train conv3x3 {C}->{C} at {H}x{W}, batch {B}, forward + "
            f"backward, f32, TF32 off: {json.dumps(out)}")
        del x, w, b, g


def main(argv):
    import torch

    if not argv or argv[0] not in ("master-batch", "train-convs"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 2
    from lmic_tpu_torch.utils.determinism import set_wire_determinism

    set_wire_determinism()
    chip_smoke.phase_environment()
    if argv[0] == "master-batch":
        master_batch([int(a) for a in argv[1:]] or [4, 6, 8, 10, 12, 16])
    else:
        train_convs()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
