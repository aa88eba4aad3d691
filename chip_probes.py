#!/usr/bin/env python3
"""One-off measurements on one GPU behind numbers in PERF.md, kept apart
from `chip_smoke.py` (whose helpers they use) because no path of the port
runs them.

    python3 chip_probes.py master-batch [--remat] [--profile] [B ...]
    python3 chip_probes.py train-convs
    python3 chip_probes.py video-convs
    python3 chip_probes.py sync-u8 ROOT [ROOT ...]

- master-batch: the largest batch of the RGB-T master's training step
  that fits, the channel-1 master q7 (f32) against its frozen guided q7 on
  512x640 thermal masters with 1024x1280 RGB guides, as `chip_smoke.py`'s
  phase 8 runs it: two steps at each batch (default 4 6 8 10 12 16),
  ascending, until one runs out of memory; each batch's step ms and peak
  memory. With --remat the step rematerializes the master's transform
  blocks as `train_cli --remat` runs it (expandable segments in the
  caching allocator), and each batch also logs the blocks whose
  backward span (from the start of the block's recompute to the next
  block's) reached the highest memory, the span of the largest setting
  the step's peak. With --profile the timed step runs under the profiler
  (and no third step): its device ms, busy share and largest kernels.
- train-convs: a 3x3 conv forward and backward under autograd, f32, TF32
  off, deterministic, at the training shapes `chip_smoke.py` logs (192 ->
  192 at 128x128, batch 16; 256 -> 256 at 512x640, batch 4), through
  cuDNN's heuristic pick (the training step's route), cuDNN's timed pick
  among its deterministic algorithms (`benchmark`), and, at the first
  shape, im2col + one cuBLAS product with autograd's fold
  (`layers._conv_gemm`): device ms, device operations, FFT kernels.
- video-convs: each 5x5 stride-2 conv and transposed conv of ssf2020's
  encoders and decoders at a 1920x1152 frame (batch 1, f32, TF32 off,
  deterministic, no autograd), through cuDNN (the layers' route) and
  through one cuBLAS product with im2col (conv) or col2im (`F.fold`,
  transposed conv): device ms, device operations, the largest kernels and
  the error against cuDNN in f64; then `crosscheck.video_agreement` and
  the strings' bytes of one 1920x1152 GOP on the card against the CPU.
- sync-u8: the synchronous uint8 `compress` and `decompress(u8=True)` of
  bmshj2018-factorized, bmshj2018-hyperprior and mbt2018-mean at quality
  8, seed 0, at the served 1x512x768 and at a batch of 16 of 768x512,
  with the port of each checkout ROOT in turn (each in a process of its
  own, the ROOTs in the order given and then in reverse, so two trees are
  timed A B B A on one card): wall ms of each call after warm-up (median
  and least of 5), the median of each stage the codec's `stats` keeps,
  and a digest of the strings and pixels, which must agree across the
  ROOTs.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke
from chip_smoke import (
    IMAGE,
    LAMBDAS,
    MASTER_BATCH,
    MASTER_GUIDE,
    PIPE_ARCHS,
    PIPE_BATCH,
    QUALITY,
    RGBT_QUALITY,
    RecomputePeaks,
    _fft_kernels,
    _images,
    _profile,
    _gop_bytes,
    _gops,
    _time_ms,
    _train_batch,
    log,
)


def master_batch(batches, remat=False, profiled=False):
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        expandable_segments,
        make_optimizer,
    )
    from lmic_tpu_torch.utils.train_cli import make_master_train_step

    if remat:  # as train_cli --remat runs
        expandable_segments("cuda")
    q = RGBT_QUALITY
    guided = zoo.create_model("guided", q, seed=0, channel=3,
                              first_stride=2, device="cuda").module
    guided.eval().requires_grad_(False)
    master = zoo.create_model("master", q, seed=1, channel=1,
                              device="cuda").module
    opt = make_optimizer()
    state = create_train_state(master, opt)
    step = make_master_train_step(master, guided, opt, LAMBDAS[q - 1],
                                  remat=remat)
    fits, spans = None, None
    for b in batches:
        try:
            xm = _train_batch((b, *MASTER_BATCH[1:]), seed=3)
            xg = _train_batch((b, *MASTER_GUIDE[1:]), seed=4)
            torch.cuda.reset_peak_memory_stats()
            step(state, xm, xg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if profiled:
                prof = _profile(lambda: step(state, xm, xg), n=1, keep=15)
            else:
                step(state, xm, xg)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated()
            if profiled:
                log(f"master batch {b} profile: device {prof[1]:.1f} ms of "
                    f"{prof[2]:.1f} ms, {prof[4]:.0f} device operations; "
                    "largest kernels (ms): " + json.dumps(
                        {k: round(v, 1) for k, v in prof[3].items()}))
            elif remat:  # a third step, its backward spans measured
                with RecomputePeaks(master) as spans:
                    step(state, xm, xg)
                    torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            log(f"master batch {b}: out of memory ({str(e).splitlines()[0]})")
            break
        finally:
            xm = xg = None
            state.main.zero_grad(set_to_none=True)
            state.aux.zero_grad(set_to_none=True)
            torch.cuda.empty_cache()
        fits = b
        log(f"master batch {b}{' remat' if remat else ''}: step {ms:.1f} "
            f"ms, peak memory {peak / 2**30:.2f} GiB of "
            f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.2f}"
            + (f"; highest backward spans (GiB): {json.dumps(spans.top())}"
               if spans else ""))
    log(f"largest master batch that fits{' with --remat' if remat else ''}"
        f": {fits} (of {list(batches)})")


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


def _video_conv_cases():
    """(name, transposed, C_in, C_out, input H, W) of ssf2020 at
    1920x1152: the encoders' convs, then the decoders' transposed convs."""
    H, W = chip_smoke.VIDEO_GOP[2:4]
    return [("enc0 img", False, 3, 128, H, W),
            ("enc0 motion", False, 6, 128, H, W),
            ("enc1", False, 128, 128, H // 2, W // 2),
            ("enc2", False, 128, 128, H // 4, W // 4),
            ("enc3", False, 128, 192, H // 8, W // 8),
            ("dec0", True, 192, 128, H // 16, W // 16),
            ("dec0 res", True, 384, 128, H // 16, W // 16),
            ("dec1", True, 128, 128, H // 8, W // 8),
            ("dec2", True, 128, 128, H // 4, W // 4),
            ("dec3", True, 128, 3, H // 2, W // 2)]


def _gemm_conv(x, w, b, transposed):
    """A 5x5 stride-2 conv (padding 2) or transposed conv (output
    padding 1) as one cuBLAS product with im2col or col2im."""
    import torch.nn.functional as F

    B, C, H, W = x.shape
    if transposed:  # w: (C_in, C_out, 5, 5)
        cols = w.flatten(1).t() @ x.reshape(B, C, H * W)
        return F.fold(cols, (2 * H, 2 * W), 5, padding=2,
                      stride=2) + b[:, None, None]
    cols = F.unfold(x, 5, padding=2, stride=2)
    out = w.flatten(1) @ cols + b[:, None]
    return out.view(B, -1, (H + 1) // 2, (W + 1) // 2)


def video_convs():
    import torch
    import torch.nn.functional as F

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.crosscheck import video_agreement

    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for name, transposed, cin, cout, H, W in _video_conv_cases():
            x = torch.randn((1, cin, H, W), generator=gen, device="cuda")
            x = x.contiguous(memory_format=torch.channels_last)
            shape = (cin, cout, 5, 5) if transposed else (cout, cin, 5, 5)
            w = torch.randn(shape, generator=gen, device="cuda") / (
                5 * cin ** 0.5)
            w = w.contiguous(memory_format=torch.channels_last)
            b = torch.randn(cout, generator=gen, device="cuda") * 0.1
            if transposed:
                def cudnn(x=x, w=w, b=b, dt=torch.float32):
                    return F.conv_transpose2d(x.to(dt), w.to(dt), b.to(dt),
                                              2, 2, 1)
            else:
                def cudnn(x=x, w=w, b=b, dt=torch.float32):
                    return F.conv2d(x.to(dt), w.to(dt), b.to(dt), 2, 2)
            ref = cudnn(dt=torch.float64)
            scale = ref.abs().max().item()
            routes = {"cudnn": cudnn,
                      "gemm": lambda x=x, w=w, b=b, t=transposed:
                      _gemm_conv(x, w, b, t)}
            out = {}
            for route, run in routes.items():
                err = (run().double() - ref).abs().max().item() / scale
                ms = _time_ms(run, runs=5, warmup=2)
                _, _, _, top, ops = _profile(run, n=1, keep=3)
                out[route] = {"ms": round(ms, 3), "rel_err": float(
                    f"{err:.3g}"), "device_operations": ops,
                    "kernels": {k: round(v, 3) for k, v in top.items()}}
            kind = "transposed conv" if transposed else "conv"
            log(f"video {name}: 5x5 stride-2 {kind} {cin}->{cout} from "
                f"{W}x{H}: {json.dumps(out)}")
            del x, w, b, ref
        torch.cuda.empty_cache()
    cuda = zoo.create_video_model(seed=0, device="cuda")
    cpu = zoo.create_video_model(seed=0, device="cpu")
    cuda.update()
    cpu.update()
    gop = _gops(1)[0]
    t0 = time.perf_counter()
    worst = video_agreement(cuda, cpu, gop)
    log(f"video CUDA vs CPU stages at {gop.shape[3]}x{gop.shape[2]}: "
        f"{worst:.3g} ({time.perf_counter() - t0:.1f} s)")
    for codec in (cuda, cpu):
        strings, _ = codec.compress(gop)
        log(f"video GOP bytes on {codec.device}: keyframe, inter frames "
            f"{_gop_bytes(strings)}")


def sync_u8_one(root, runs=5):
    """sync-u8 for the port of the checkout `root`: one JSON line."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import lmic_tpu_torch
    from lmic_tpu_torch import zoo

    where = os.path.dirname(os.path.dirname(lmic_tpu_torch.__file__))
    if where != os.path.abspath(root):
        raise AssertionError(f"lmic_tpu_torch imported from {where}")
    result = {"root": root}
    for arch in PIPE_ARCHS[::-1]:
        codec = zoo.create_model(arch, QUALITY, seed=0, device="cuda")
        codec.update()
        for shape in (IMAGE, PIPE_BATCH):
            x = np.concatenate(_images(shape[0], shape, seed=5))
            digest = hashlib.sha256()
            times = {"compress": [], "decompress": []}
            stages = {}
            for i in range(2 + runs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = codec.compress(x)
                t1 = time.perf_counter()
                rec = codec.decompress(out["strings"], out["shape"],
                                       u8=True)["x_hat"]
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if i == 0:
                    for group in out["strings"]:
                        for string in group:
                            digest.update(string)
                    digest.update(rec.tobytes())
                if i >= 2:
                    times["compress"].append(1e3 * (t1 - t0))
                    times["decompress"].append(1e3 * (t2 - t1))
                    for k, v in codec.stats.items():
                        stages.setdefault(k, []).append(v)
            result[f"{arch} {'x'.join(map(str, shape))}"] = {
                "digest": digest.hexdigest()[:16],
                **{k: [round(float(np.median(v)), 2), round(min(v), 2)]
                   for k, v in times.items()},
                "stages": {k: round(float(np.median(v)), 2)
                           for k, v in stages.items()}}
        del codec
    log(json.dumps(result))


def sync_u8(roots):
    """sync-u8 for each ROOT, A B B A, each in a process of its own; the
    digests must agree across the ROOTs."""
    here = os.path.dirname(os.path.abspath(__file__))
    results = []
    for root in list(roots) + list(roots)[::-1]:
        code = ("import chip_probes; "
                f"chip_probes.sync_u8_one({os.path.abspath(root)!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=here,
                              capture_output=True, text=True, timeout=600)
        if proc.returncode:
            raise AssertionError(f"sync-u8 {root}: {proc.stderr[-2000:]}")
        line = proc.stdout.strip().splitlines()[-1]
        log(line)
        results.append(json.loads(line))
    for key in results[0]:
        if key != "root" and len({r[key]["digest"] for r in results}) != 1:
            raise AssertionError(f"sync-u8: {key}'s bytes differ across "
                                 "the checkouts")
    log("sync-u8: every checkout's strings and pixels agree")


def main(argv):
    import torch

    probes = ("master-batch", "train-convs", "video-convs", "sync-u8")
    if not argv or argv[0] not in probes:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 2
    from lmic_tpu_torch.utils.determinism import set_wire_determinism

    set_wire_determinism()
    chip_smoke.phase_environment()
    if argv[0] == "master-batch":
        flags = ("--remat", "--profile")
        master_batch([int(a) for a in argv[1:] if a not in flags]
                     or [4, 6, 8, 10, 12, 16], "--remat" in argv[1:],
                     "--profile" in argv[1:])
    elif argv[0] == "train-convs":
        train_convs()
    elif argv[0] == "sync-u8":
        sync_u8(argv[1:] or [os.path.dirname(os.path.abspath(__file__))])
    else:
        video_convs()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
