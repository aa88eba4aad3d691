#!/usr/bin/env python3
"""One-off measurements on one GPU behind numbers in PERF.md, kept apart
from `chip_smoke.py` (whose helpers they use) because no path of the port
runs them.

    python3 chip_probes.py master-batch [--remat] [--profile] [B ...]
    python3 chip_probes.py train-convs
    python3 chip_probes.py video-convs
    python3 chip_probes.py sync-u8 ROOT [ROOT ...]
    python3 chip_probes.py gdn-ab [--off-route] ROOT [ROOT ...]
    python3 chip_probes.py gdn-host PARENT
    python3 chip_probes.py gdn-fwd-tiles
    python3 chip_probes.py gdn-fwd-sqrt
    python3 chip_probes.py gdn-fwd-stream
    python3 chip_probes.py gdn-dx-stream
    python3 chip_probes.py gdn-f32-blocked
    python3 chip_probes.py bf16-step
    python3 chip_probes.py amp-narrow
    python3 chip_probes.py wide-steps

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
- gdn-ab: the GDN kernels of each checkout ROOT in turn, A B B A as
  sync-u8 runs them, each in a process of its own that imports that
  ROOT's `chip_smoke.py` and port: the kernel phase's per-step totals (ms,
  plain, bound, library) of every GDN kernel at the training rows, C = 192,
  f32 and bf16, the bf16 `gdn_fwd` of a --remat step (each layer twice)
  and of each layer alone (µs, GDN and IGDN, C = 192 and 128); an on-card
  checksum of every f32 output (gdn_fwd, and each of
  gdn_bwd's three launches: dx and the dn scratch, the partials, dbeta and
  dgamma) at every f32 shape of the kernel phase, and of the bf16 partials
  and reduce on fixed seeded inputs (x, dn, tile sums), all of which must
  agree across the ROOTs, also at the f32 shapes past 384 channels
  (AB_WIDE_F32, the forward alone at AB_WIDE_F32_FWD), with the device
  µs a launch of gdn_fwd and gdn_bwd_dx there; and phase 5's AMP step
  (mbt2018-mean q7, batch 16 of 256x256): step ms, peak memory, and
  device ms and busy share from
  a profile; and the bf16 `gdn_fwd` off the wide route (C = 320 and 256
  at 16,391 and 262,144 rows, both directions) through the ROOT's own
  wrapper and route: device µs and the CUDA kernel it took (its C ABI's
  counts), and so the bf16 `gdn_bwd_dx` there (one launch through the
  ROOT's C ABI). With --off-route each process runs those parts alone,
  then phase 17's AMP step (the same step at N = M = 320, whose GDN runs
  on the off-route kernels): step ms, peak memory, device ms, GDN ms and
  busy share.
  Host times of separate processes differ by tens of µs on a
  host shared with others, so gdn-host compares them in one process:
- gdn-host: the gdn_fwd and gdn_bwd libraries of the checkout PARENT
  beside this tree's in one process, in turns (a parent without the
  forward's or the dx pass's scratch query takes no scratch there):
  the host µs of one
  `lmic_gdn_fwd` call on each bf16 route and in f32, with the device µs
  of each call beside it, of one `lmic_gdn_bwd_dx` call on each bf16
  route and in f32, of one `gdn_bwd` call, and phase 5's AMP step ms with
  each pair of libraries in ops/gdn.py. This is the port's one
  measurement of host cost.
- gdn-fwd-tiles: bf16 `gdn_fwd` on its wide route at k tiles of 64 rows
  for each of the card's SMs (k = 1, 2, 3, 4, 8, 16, 32), C = 192 and
  128, both directions: device µs of each, and the least-squares line
  a + b k, whose intercept a is what a launch costs beside its tiles (the
  launch, gamma's load, the first tile's latency, the last one's store)
  and b a tile's share; then the same launches of a copy of the kernel
  built without gamma's load (its outputs are wrong; only its time is
  read), whose difference is what gamma's load costs a launch: the most a
  cluster sharing gamma's load could save.
- gdn-fwd-sqrt: the IGDN of bf16 `gdn_fwd` on its wide route, whose
  epilogue takes sqrt(norm) as one Newton step from norm * rsqrtf(norm),
  against a copy of the kernel built with IEEE `sqrtf` there, at the
  training rows (and 1,572,864), C = 192 and 128: the output elements
  that differ, and the device µs of each, in turns.
- gdn-fwd-stream: bf16 `gdn_fwd` on `gdn_fwd_stream_kernel` (C = 320 and
  256 at 262,144 rows, 320 and 1024 at 16,391) against copies of the
  kernel built with another ring and output tiles (2 stages; 4 stages and
  one output tile, the store read before a block's first x is kept),
  without the producer's registers handed to the consumers, or with the
  products x * bf16(scale) in f32 and rounded by a conversion,
  in turns: device µs of each, and the outputs, which must be equal byte
  for byte (the same sums in the same order); and a copy without the
  products and a copy whose epilogue stores x as y (timing only: their
  outputs are wrong), the time the rest takes without each. Fewer stages in flight that cost
  time say the kernel waits on its loads' latency.
- gdn-f32-blocked: f32 `gdn_fwd` on `gdn_fwd_f32_blocked_kernel` and
  `gdn_bwd_dx` on `gdn_bwd_dx_f32_blocked_kernel` (GDN; 262,144 x 512
  and 16,391 rows at C = 512, 1024, 2048, 385 and 640, 24,576 to 4,096
  rows at 512, 4,096, 1,000 and 129 rows at 2048) against copies built with
  other constants of the blocked loop (2 or 3 stages, 1 or all 8 4-deep
  steps of a slice unrolled, a thread's rows consecutive), other tiles
  (128 x 128 or 64 x 256 of 8 x 8 sums a thread) or other routes (the
  forward's small tiles never or always, three or two CTAs an SM, no
  128-column blocks, dx without clusters), in turns: device µs of each, ptxas's registers and
  spills, and the outputs, which must be equal byte for byte; the SM
  clock and power draw nvidia-smi reads while each kernel runs; the
  forward's IGDN against a copy with IEEE sqrtf in place of its Newton
  step from rsqrtf (µs, whether the bytes are equal); then, for information, C = 192 and 128
  routed to the blocked kernels against the whole-width ones (µs, equal
  bytes).
- gdn-dx-stream: bf16 `gdn_bwd_dx` on `gdn_bwd_dx_stream_kernel` (GDN;
  C = 320 and 256 at 262,144 rows, 320 and 1024 at 16,391) against copies
  of the kernel built with 2 stages, with the workspace read after pass
  2's products instead of beside them, or with the workspace read and
  written through L2 only, in turns: device µs of each, and their dx, dn
  and tile sums,
  which must be within the bf16 bar of the kernel's (whether the bytes
  are equal is logged); and copies without the products, without either
  pass's elementwise arithmetic and without the workspace's stores and
  loads (timing only: their outputs are wrong).
- bf16-step: one step of a narrow mbt2018-mean (q7, N = 32, M = 48,
  batch 2 of 64x128, seed 0, `crosscheck.fixed_noise`) on the card
  against the CPU: in f32, under `--bf16` as the port runs it (TF32 on
  the rounded operands), and under `--bf16` with the rounded operands in
  FP32 (TF32 off), each the losses' largest relative difference, the
  clipped gradients' relative Frobenius error as one vector and the root
  mean square of each leaf's, and the worst leaves; then the rounding's
  own effect, the CPU's `--bf16` step against its f32 step.
- amp-narrow: the AMP step of a narrow mbt2018-mean (`_narrow_step`,
  bf16 compute) at N = 40, 32 and 192 (M = 48) on the card against the
  CPU, by `chip_smoke._amp_leaf_gaps` and `_step_gap`, twice: with the
  GDN kernels, and with the card running the plain versions in their
  place (ops/gdn.py's `gdn_fwd` and `gdn_bwd` swapped for
  `gdn_reference` and `gdn_bwd_reference` in this process); the
  hyper-path leaves over the CPU AMP test's bar (2e-2 + twice the CPU's
  AMP effect); and the kernels' step against the plain versions' on the
  card.
- wide-steps: `chip_smoke.py` phase 18's wide AMP model (mbt2018-mean q7
  at N = 1152, M = 320, seed 0, batch 4 of 256x256) stepped 4 times from
  its init in AMP and in f32, with the GDN kernels and with the plain
  versions in their place on the card (as amp-narrow swaps them): each
  run's losses, to tell the model's own first steps from a kernel's.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
    _narrow_step,
    _profile,
    _gop_bytes,
    _gops,
    _step_gap,
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


def _checksum(t):
    """A digest of a tensor's bytes, computed on the card: the sum mod
    2^64 of each 32-bit word (plus one) times a multiplier that depends on
    its index, with the shape."""
    import torch

    words = t.contiguous().view(-1).view(torch.int32).to(torch.int64) + 1
    index = torch.arange(words.numel(), device=t.device, dtype=torch.int64)
    total = (words * (index * 2654435761 + 1)).sum().item()
    return f"{tuple(t.shape)}:{total & (2**64 - 1):016x}"


# the f32 shapes past 384 channels, as (rows, C, offset of x in elements),
# that chip_smoke.py holds the blocked kernels to (WIDE_F32_CASES; the
# forward alone at WIDE_F32_SERVE_ROWS x 512), written out here so that a
# checkout whose chip_smoke.py lacks some of them is held to all of them
AB_WIDE_F32 = ([(16_391, C, 0) for C in (385, 512, 1024, 2048)]
               + [(n, 512, 0) for n in (262_144, 65_536, 16_384)]
               + [(16_391, 512, 1), (16_391, 640, 0), (129, 2048, 0)])
AB_WIDE_F32_FWD = [(n, 512, 0) for n in (98_304, 24_576, 6_144)]


def _f32_checksums(wide_us=None):
    """{shape and direction: checksums of the f32 outputs} of gdn_fwd and of
    gdn_bwd's three launches at every f32 shape of the kernel phase, and
    at AB_WIDE_F32 and AB_WIDE_F32_FWD, whose device µs a launch of
    gdn_fwd and of gdn_bwd_dx go to `wide_us` when given."""
    import torch

    from lmic_tpu_torch.ops import gdn

    cs = chip_smoke
    f32_only = cs.RGBT_ROWS + cs.MASTER_GUIDE_ROWS + cs.PIPE_ROWS
    shapes = [(n, C) for C in (128, 192) for n in cs.SERVE_ROWS
              + cs.TRAIN_ROWS] + [(n, 192) for n in f32_only]
    fwd_only = tuple(n for n in cs.SERVE_ROWS + f32_only
                     if n not in cs.MASTER_TRAIN_ROWS)
    out = {}
    for n, C in shapes:
        for inverse in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(n * 1000 + C)
            x, beta, gamma, g = cs._gdn_inputs(gen, n, C, torch.float32)
            key = f"{n}x{C} inverse={inverse}"
            sums = [_checksum(gdn.gdn_fwd(x, beta, gamma, inverse))]
            if n not in fwd_only:
                launch = cs._bwd_launches(x, beta, gamma,
                                          gamma.t().contiguous(), g, inverse)
                for name in gdn.BWD_KERNELS:  # dx, partials, reduce in turn
                    sums += [_checksum(t) for t in launch[name]()]
            out[key] = sums
            del x, beta, gamma, g
    for n, C, offset in AB_WIDE_F32 + AB_WIDE_F32_FWD:
        for inverse in (False, True):
            gen = torch.Generator(device="cuda").manual_seed(n * 1000 + C)
            x, beta, gamma, g = cs._gdn_inputs(gen, n, C, torch.float32)
            buf = torch.empty(n * C + offset, device="cuda")
            buf[offset:].copy_(x.view(-1))
            x = buf[offset:].view(n, C)
            key = f"{n}x{C}+{offset} inverse={inverse}"
            fwd = (lambda: gdn.gdn_fwd(x, beta, gamma, inverse))
            sums = [_checksum(fwd())]
            us = [1e3 * cs._time_ms(fwd)] if wide_us is not None else []
            if (n, C, offset) in AB_WIDE_F32:
                launch = cs._bwd_launches(x, beta, gamma,
                                          gamma.t().contiguous(), g, inverse)
                for name in gdn.BWD_KERNELS:  # dx, partials, reduce in turn
                    sums += [_checksum(t) for t in launch[name]()]
                if wide_us is not None:
                    us.append(1e3 * cs._time_ms(launch["gdn_bwd_dx"]))
            out[key] = sums
            if wide_us is not None:
                wide_us[key] = us
            del x, beta, gamma, g, buf
            torch.cuda.empty_cache()
    return out


def _bf16_sums_checksums():
    """{shape: checksums of the bf16 partials, dbeta and dgamma} from
    `gdn_bwd_partials` and `gdn_bwd_reduce` on fixed seeded inputs made
    here (x, a bf16 dn, f32 tile sums; not the dx kernel's output), at the
    kernel phase's bf16 backward shapes and at three off the dx kernel's
    TMA route (C = 37, a ragged 70,001 rows, C = 432), through the C ABI."""
    import torch

    from lmic_tpu_torch.ops import gdn

    lib = gdn._load("gdn_bwd.cu")
    rows, tile = lib.lmic_gdn_bwd_chunk_rows(), lib.lmic_gdn_bwd_tile_rows()
    shapes = [(n, C) for C in (128, 192) for n in chip_smoke.TRAIN_ROWS]
    shapes += [(5_000, 37), (70_001, 192), (16_391, 432)]
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for n, C in shapes:
        gen = torch.Generator(device="cuda").manual_seed(n * 1000 + C)
        x = torch.randn((n, C), generator=gen, device="cuda").bfloat16()
        dn = (0.1 * torch.randn((n, C), generator=gen, device="cuda")
              ).bfloat16()
        sums = torch.randn((-(-n // tile), C), generator=gen, device="cuda")
        chunks = -(-n // rows)
        partials = torch.empty((chunks, C * C + C), device="cuda")
        dbeta = torch.empty(C, dtype=torch.bfloat16, device="cuda")
        dgamma = torch.empty((C, C), dtype=torch.bfloat16, device="cuda")
        for err in (
                lib.lmic_gdn_bwd_partials(x.data_ptr(), dn.data_ptr(),
                                          sums.data_ptr(),
                                          partials.data_ptr(), n, C, 1,
                                          stream),
                lib.lmic_gdn_bwd_reduce(partials.data_ptr(),
                                        dbeta.data_ptr(), dgamma.data_ptr(),
                                        chunks, C, 1, stream)):
            if err:
                raise RuntimeError(
                    lib.lmic_gdn_bwd_error_string(err).decode())
        # bf16 -> f32 is exact, and gives whole 32-bit words
        out[f"{n}x{C}"] = [_checksum(partials), _checksum(dbeta.float()),
                           _checksum(dgamma.float())]
    return out


def _amp_step(timed=5, widths=None):
    """Phase 5's AMP training step (phase 17's with `widths`, its N and
    M): step ms (median), peak memory, and the device ms, GDN ms and busy
    share of a profiled step."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    cs = chip_smoke
    batch = _train_batch(cs.TRAIN_BATCH, seed=1)
    module = zoo.create_model(cs.TRAIN_ARCH, cs.TRAIN_QUALITY, seed=0,
                              device="cuda", dtype=torch.bfloat16,
                              **(widths or {})).module
    opt = make_optimizer()
    state = create_train_state(module, opt)
    step = make_train_step(module, opt, cs.TRAIN_LAMBDA)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cs._steps(step, state, batch, gen, 2)
    torch.cuda.reset_peak_memory_stats()
    ms, _ = cs._steps(step, state, batch, gen, timed)
    peak = torch.cuda.max_memory_allocated()
    gdn_ms, dev_ms, wall_ms, _, _ = _profile(lambda: step(state, batch, gen))
    return {"step_ms": float(np.median(ms)), "peak_gib": peak / 2**30,
            "device_ms": dev_ms, "gdn_ms": gdn_ms,
            "busy": dev_ms / wall_ms}


OFF_ROUTE_FWD = ((16_391, 320), (262_144, 320), (16_391, 256),
                 (262_144, 256))


def _off_route_fwd():
    """{shape and direction: {"kernel", "us"}} of bf16 gdn_fwd at each of
    OFF_ROUTE_FWD through this process's port: the CUDA kernel its route
    took by the C ABI's counts, and the device µs a launch."""
    import torch

    from lmic_tpu_torch.ops import gdn

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n, C in OFF_ROUTE_FWD:
        x, beta, gamma, _ = chip_smoke._gdn_inputs(gen, n, C, torch.bfloat16)
        for inverse in (False, True):
            torch.cuda.synchronize()
            before = gdn.kernel_launches()
            gdn.gdn_fwd(x, beta, gamma, inverse)
            torch.cuda.synchronize()
            took = [k for k, v in gdn.kernel_launches().items()
                    if v != before.get(k, 0)]
            out[f"{n}x{C} {'IGDN' if inverse else 'GDN'}"] = {
                "kernel": took, "us": 1e3 * _time_ms(
                    lambda: gdn.gdn_fwd(x, beta, gamma, inverse))}
        del x, beta, gamma
    return out


def _off_route_dx():
    """{shape and direction: {"kernel", "us"}} of bf16 gdn_bwd_dx at each
    of OFF_ROUTE_FWD through this process's chip_smoke and port, one
    launch through the C ABI as the kernel phase times it: the CUDA kernel
    its route took by the C ABI's counts, and the device µs a launch."""
    import torch

    from lmic_tpu_torch.ops import gdn

    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for n, C in OFF_ROUTE_FWD:
        x, beta, gamma, g = chip_smoke._gdn_inputs(gen, n, C, torch.bfloat16)
        for inverse in (False, True):
            run = chip_smoke._bwd_launches(x, beta, gamma,
                                           gamma.t().contiguous(), g,
                                           inverse)["gdn_bwd_dx"]
            torch.cuda.synchronize()
            before = gdn.kernel_launches()
            run()
            torch.cuda.synchronize()
            took = [k for k, v in gdn.kernel_launches().items()
                    if v != before.get(k, 0)]
            out[f"{n}x{C} {'IGDN' if inverse else 'GDN'}"] = {
                "kernel": took, "us": 1e3 * _time_ms(run)}
        del x, beta, gamma, g
    return out


def gdn_ab_one(root, off_route=False):
    """gdn-ab for the checkout `root`, whose chip_smoke.py this process has
    imported: one JSON line."""
    import torch

    from lmic_tpu_torch import ops
    from lmic_tpu_torch.utils.determinism import set_wire_determinism

    for mod in (chip_smoke, ops):
        where = os.path.abspath(mod.__file__)
        if not where.startswith(os.path.abspath(root) + os.sep):
            raise AssertionError(f"{mod.__name__} imported from {where}")
    set_wire_determinism()
    if off_route:
        result = {"root": root, "off_route_fwd": _off_route_fwd(),
                  "off_route_dx": _off_route_dx()}
        torch.cuda.empty_cache()
        result["off_route_step"] = _amp_step(
            widths=chip_smoke.OFF_ROUTE_WIDTHS)
        log(json.dumps(result))
        return
    cs = chip_smoke
    cases = cs.phase_kernel(cs._peaks(torch.cuda.get_device_name(0)))
    result = {"root": root, "step": {
        kernel: {dtype: cs._totals(cases, kernel, cs.TRAIN_ROWS[:3], dtype)
                 for dtype in ("float32", "bfloat16")}
        for kernel in cases}}
    result["remat_bf16_fwd"] = cs._totals(cases, "gdn_fwd", cs.REMAT_ROWS,
                                          "bfloat16")
    # each layer's GDN and IGDN µs; the aligned operands (the off-route
    # cases carry an offset)
    result["bf16_fwd_by_layer"] = {
        f"{n}x{C}": [c["us"] for c in sorted(
            (c for c in cases["gdn_fwd"] if c["shape"] == [n, C]
             and c["dtype"] == "bfloat16" and "offset" not in c),
            key=lambda c: c["inverse"])]
        for C in (192, 128) for n in cs.TRAIN_ROWS[:3]}
    result["wide_f32_us"] = {}
    result["f32_checksums"] = _f32_checksums(result["wide_f32_us"])
    result["bf16_sums_checksums"] = _bf16_sums_checksums()
    torch.cuda.empty_cache()
    result["amp_step"] = _amp_step()
    result["off_route_fwd"] = _off_route_fwd()
    result["off_route_dx"] = _off_route_dx()
    log(json.dumps(result))


def gdn_ab(roots, off_route=False):
    """gdn-ab for each ROOT, A B B A, each in a process of its own; the f32
    checksums must agree across the ROOTs and runs (with `off_route`, the
    off-route forward and dx and phase 17's step alone, which keep no
    checksum)."""
    here = os.path.dirname(os.path.abspath(__file__))
    results = []
    for root in list(roots) + list(roots)[::-1]:
        root = os.path.abspath(root)
        # the ROOT's chip_smoke and port; this file's probe, by its path
        code = (f"import importlib.util, sys; sys.path.insert(0, {root!r}); "
                "import chip_smoke; spec = importlib.util."
                f"spec_from_file_location('chip_probes', {__file__!r}); "
                "probes = importlib.util.module_from_spec(spec); "
                "spec.loader.exec_module(probes); "
                f"probes.gdn_ab_one({root!r}, {off_route!r})")
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise AssertionError(f"gdn-ab {root}: {proc.stderr[-3000:]}")
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        results.append(result)
        for part in ("fwd", "dx"):
            log(f"gdn-ab {root} off-route bf16 gdn_{part}: " + json.dumps({
                k: [v["kernel"], round(v["us"], 2)]
                for k, v in result[f"off_route_{part}"].items()}))
        if off_route:
            log(f"gdn-ab {root} phase 17's AMP step: " + json.dumps(
                {k: round(v, 4) for k, v in result["off_route_step"].items()}))
            continue
        step, amp = result["step"], result["amp_step"]
        log(f"gdn-ab {root}: " + json.dumps({
            "ms_per_step": {k: {d: round(v[d]["ms"], 4) for d in v}
                            for k, v in step.items()},
            "remat_bf16_fwd_ms": round(result["remat_bf16_fwd"]["ms"], 4),
            "bf16_fwd_us_by_layer": {
                k: [round(u, 1) for u in v]
                for k, v in result["bf16_fwd_by_layer"].items()},
            "amp_step": {k: round(v, 4) for k, v in amp.items()}}))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    with open(os.path.join(here, "chiprun_out", "gdn_ab.json"), "w") as f:
        json.dump(results, f, indent=1)
    if off_route:
        return
    # the f32 kernels past 384 channels: µs a launch (gdn_fwd, gdn_bwd_dx),
    # the least of each checkout's two processes
    roots_ab = list(dict.fromkeys(r["root"] for r in results))
    for key in results[0]["wide_f32_us"]:
        best = {root: [min(r["wide_f32_us"][key][i] for r in results
                           if r["root"] == root)
                       for i in range(len(results[0]["wide_f32_us"][key]))]
                for root in roots_ab}
        log(f"gdn-ab f32 {key} µs (gdn_fwd, gdn_bwd_dx): " + ", ".join(
            f"{os.path.basename(root)} "
            + " / ".join(f"{u:.1f}" for u in v) for root, v in best.items()))
    for sums in ("f32_checksums", "bf16_sums_checksums"):
        for key in results[0][sums]:
            if len({json.dumps(r[sums][key]) for r in results}) != 1:
                raise AssertionError(f"gdn-ab: {sums} at {key} differ")
    log(f"gdn-ab: every f32 output agrees across the checkouts and runs "
        f"({len(results[0]['f32_checksums'])} shapes and directions), and "
        f"so do the bf16 partials and reduce on fixed inputs "
        f"({len(results[0]['bf16_sums_checksums'])} shapes)")


def _host_us(fn, runs=50):
    """Host µs a call of `fn`: the wall time of `runs` calls issued while a
    spin kernel keeps the card busy, so no call waits on the device."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # cycles: ~100 ms at H100 clocks
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / runs


def _bind(lib, source="gdn_bwd.cu"):
    """`lib` with ops/gdn.py's ctypes signatures of `source`, as `_load`
    binds them. A forward library without `lmic_gdn_fwd_scratch_bytes`
    gets one that answers 0 and an `lmic_gdn_fwd` that drops the scratch
    argument; so does a backward library without
    `lmic_gdn_bwd_dx_scratch_bytes` for `lmic_gdn_bwd_dx`. One without
    the per-kernel launch counts is left without them
    (`gdn.kernel_launches` skips it)."""
    from lmic_tpu_torch.ops import gdn

    adapted = ()
    if source == "gdn_fwd.cu" and not hasattr(lib,
                                              "lmic_gdn_fwd_scratch_bytes"):
        # a forward without the stream kernel's copies takes no scratch
        # argument and needs none
        fwd = lib.lmic_gdn_fwd
        args = gdn._SIGNATURES[source]["lmic_gdn_fwd"]
        fwd.argtypes = args[:-2] + args[-1:]
        fwd.restype = gdn._restype("lmic_gdn_fwd")
        lib.lmic_gdn_fwd = lambda *a: fwd(*a[:-2], a[-1])
        lib.lmic_gdn_fwd_scratch_bytes = lambda *args: 0
        adapted = ("lmic_gdn_fwd", "lmic_gdn_fwd_scratch_bytes")
    if source == "gdn_bwd.cu" and not hasattr(
            lib, "lmic_gdn_bwd_dx_scratch_bytes"):
        # a backward without the stream dx kernel's workspace takes no
        # scratch argument and needs none
        dx = lib.lmic_gdn_bwd_dx
        args = gdn._SIGNATURES[source]["lmic_gdn_bwd_dx"]
        dx.argtypes = args[:-2] + args[-1:]
        dx.restype = gdn._restype("lmic_gdn_bwd_dx")
        lib.lmic_gdn_bwd_dx = lambda *a: dx(*a[:-2], a[-1])
        lib.lmic_gdn_bwd_dx_scratch_bytes = lambda *args: 0
        adapted = ("lmic_gdn_bwd_dx", "lmic_gdn_bwd_dx_scratch_bytes")
    for name, argtypes in gdn._SIGNATURES[source].items():
        if name in adapted:
            continue
        counts = name.endswith(("_kernel_name", "_kernel_launches"))
        if counts and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = gdn._restype(name)
    return lib


def gdn_host(parent, rounds=3, n=65_536, C=192):
    """gdn-host: the gdn_fwd and gdn_bwd libraries of the checkout `parent`
    and this tree's in one process (`_bind` gives the parent's the C ABI
    ops/gdn.py's wrapper calls), in turns: the host µs
    of one `lmic_gdn_fwd` call and one `lmic_gdn_bwd_dx` call (bf16 on its
    TMA route and off it, through a view offset by one element; f32),
    with the device µs of each `lmic_gdn_fwd` call, of one `gdn.gdn_bwd`
    call, and phase 5's AMP step ms (median of 5 after 2 warm-up
    steps)."""
    import importlib.util

    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    cs = chip_smoke
    spec = importlib.util.spec_from_file_location(
        "parent_build",
        os.path.join(parent, "lmic_tpu_torch", "ops", "_build.py"))
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)  # builds under the parent's _build/
    libs = {"parent": _bind(build.load("gdn_bwd.cu")),
            "change": gdn._load("gdn_bwd.cu")}
    fwd_libs = {"parent": _bind(build.load("gdn_fwd.cu"), "gdn_fwd.cu"),
                "change": gdn._load("gdn_fwd.cu")}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    fwd_calls, fwd_device = {}, {}
    for dt in (torch.bfloat16, torch.float32):
        x, beta, gamma, _ = cs._gdn_inputs(gen, n, C, dt)
        # the f32 kernel reads gamma^T, the bf16 kernels gamma
        w = gamma.t().contiguous() if dt == torch.float32 else gamma
        y = torch.empty_like(x)
        spare = torch.empty(n * C + 1, dtype=dt, device="cuda")
        routes = {"aligned": x}
        if dt == torch.bfloat16:
            routes["offset"] = spare[1:].view(n, C)
        for _ in range(rounds):
            for which, lib in fwd_libs.items():
                for route, xi in routes.items():
                    nbytes = lib.lmic_gdn_fwd_scratch_bytes(
                        xi.data_ptr(), w.data_ptr(), y.data_ptr(), n, C,
                        gdn._DTYPE_CODES[dt])
                    scratch = torch.empty(nbytes, dtype=torch.uint8,
                                          device="cuda")

                    def call(lib=lib, xi=xi, scratch=scratch):
                        if lib.lmic_gdn_fwd(
                                xi.data_ptr(), w.data_ptr(),
                                beta.data_ptr(), y.data_ptr(), n, C,
                                gdn._DTYPE_CODES[dt], 0,
                                scratch.data_ptr() if nbytes else None,
                                stream):
                            raise RuntimeError(f"{which} {route}")
                    key = f"{str(dt).split('.')[-1]} {route} {which}"
                    fwd_calls.setdefault(key, []).append(
                        _host_us(call, runs=100))
                    fwd_device.setdefault(key, []).append(
                        1e3 * _time_ms(call))
    calls = {}
    for dt in (torch.bfloat16, torch.float32):
        x, beta, gamma, g = cs._gdn_inputs(gen, n, C, dt)
        gamma_t = gamma.t().contiguous()
        dx = torch.empty_like(x)
        dn, dn_sums = gdn._dn_scratch(libs["change"], n, C, dt, "cuda")
        spare = torch.empty(n * C + 1, dtype=dt, device="cuda")
        routes = {"aligned": x}
        if dt == torch.bfloat16:
            routes["offset"] = spare[1:].view(n, C)
        for _ in range(rounds):
            for which, lib in libs.items():
                for route, xi in routes.items():
                    nbytes = lib.lmic_gdn_bwd_dx_scratch_bytes(
                        xi.data_ptr(), g.data_ptr(), gamma.data_ptr(),
                        dx.data_ptr(), dn.data_ptr(), n, C,
                        gdn._DTYPE_CODES[dt])
                    scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8,
                                          device="cuda")

                    def call(lib=lib, xi=xi, scratch=scratch):
                        if lib.lmic_gdn_bwd_dx(
                                xi.data_ptr(), g.data_ptr(),
                                gamma_t.data_ptr(), gamma.data_ptr(),
                                beta.data_ptr(), dx.data_ptr(),
                                dn.data_ptr(), dn_sums.data_ptr(), n, C,
                                gdn._DTYPE_CODES[dt], 0, scratch.data_ptr(),
                                stream):
                            raise RuntimeError(f"{which} {route}")
                    key = f"{str(dt).split('.')[-1]} {route} {which}"
                    calls.setdefault(key, []).append(
                        _host_us(call, runs=100))
    batch = _train_batch(cs.TRAIN_BATCH, seed=1)
    module = zoo.create_model(cs.TRAIN_ARCH, cs.TRAIN_QUALITY, seed=0,
                              device="cuda", dtype=torch.bfloat16).module
    opt = make_optimizer()
    state = create_train_state(module, opt)
    step = make_train_step(module, opt, cs.TRAIN_LAMBDA)
    step_gen = torch.Generator(device="cuda").manual_seed(0)
    x, beta, gamma, g = cs._gdn_inputs(gen, n, C, torch.bfloat16)
    steps, wrapper = {}, {}
    for k in range(2 * rounds):  # parent first in even rounds
        for which in (("parent", "change") if k % 2 == 0
                      else ("change", "parent")):
            gdn._libs["gdn_bwd.cu"] = libs[which]
            gdn._libs["gdn_fwd.cu"] = fwd_libs[which]
            cs._steps(step, state, batch, step_gen, 2)
            ms, _ = cs._steps(step, state, batch, step_gen, 5)
            steps.setdefault(which, []).append(float(np.median(ms)))
            wrapper.setdefault(which, []).append(
                _host_us(lambda: gdn.gdn_bwd(x, beta, gamma, g)))
    gdn._libs["gdn_bwd.cu"] = libs["change"]
    gdn._libs["gdn_fwd.cu"] = fwd_libs["change"]
    result = {"lmic_gdn_fwd_us": fwd_calls,
              "lmic_gdn_fwd_device_us": fwd_device,
              "lmic_gdn_bwd_dx_us": calls, "gdn_bwd_us": wrapper,
              "amp_step_ms": steps}
    log("gdn-host: " + json.dumps(result))
    for key, v in sorted({**{f"{k} fwd call": v
                             for k, v in fwd_calls.items()},
                          **{f"{k} fwd device": v
                             for k, v in fwd_device.items()},
                          **{f"{k} call": v for k, v in calls.items()},
                          **{f"{k} gdn_bwd": v for k, v in wrapper.items()},
                          **{f"{k} step": v
                             for k, v in steps.items()}}.items()):
        log(f"gdn-host {key}: median {np.median(v):.2f} of "
            + ", ".join(f"{u:.2f}" for u in v))


def _patched(edits, source="gdn_fwd.cu"):
    """ctypes handle of a copy of csrc/`source` with each (regex, text) of
    `edits` applied once, built beside copies of the shared headers and
    bound as ops/gdn.py binds the source's library; an edit (header,
    regex, text) applies to that header's copy instead."""
    import ctypes
    import glob
    import re
    import shutil
    import tempfile

    from lmic_tpu_torch.ops import _build, gdn

    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    for header in glob.glob(os.path.join(_build.CSRC, "*.cuh")):
        shutil.copy(header, tmp)
    shutil.copy(os.path.join(_build.CSRC, source), tmp)
    for edit in edits:
        name, pattern, text = edit if len(edit) == 3 else (source, *edit)
        with open(os.path.join(tmp, name)) as f:
            src = f.read()
        src, hits = re.subn(pattern, text, src, count=1, flags=re.S)
        if hits != 1:
            raise AssertionError(f"{name}: no {pattern!r} to patch")
        with open(os.path.join(tmp, name), "w") as f:
            f.write(src)
    lib = os.path.join(tmp, "libpatched.so")
    cmd = _build._command(source, lib)
    cmd[cmd.index(os.path.join(_build.CSRC, source))] = os.path.join(
        tmp, source)
    built = subprocess.run(cmd, check=True, capture_output=True, text=True)
    handle = ctypes.CDLL(lib)
    handle.ptxas = built.stdout + built.stderr  # -Xptxas -v's report
    for name, argtypes in gdn._SIGNATURES[source].items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = gdn._restype(name)
    return handle


def _spills(lib, kernel):
    """The registers and spill bytes ptxas reported for each
    instantiation of `kernel` in a `_patched` library, with the first of
    its mangled template arguments."""
    out, current = [], None
    for line in lib.ptxas.splitlines():
        found = (chip_smoke._mangled_kernel(line) if re.search(
            r"entry function '|Function properties for ", line) else None)
        if found:
            current, args = found
            continue
        if current != kernel:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.append({"instance": args[len(kernel):],
                        "spill": [int(m.group(1)), int(m.group(2))]})
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m.group(1))
    return out


def gdn_fwd_tiles(ks=(1, 2, 3, 4, 8, 16, 32)):
    """gdn-fwd-tiles: bf16 gdn_fwd on its wide route at k 64-row tiles for
    each SM, C = 192 and 128, both directions, with and without gamma's
    load; device µs of each and the least-squares line a + b k."""
    import torch

    from lmic_tpu_torch.ops import gdn

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the wide kernel without gamma's load and the wait for it
    no_gamma = _patched([
        (r"\n *hop::mbar_expect\(&gamma_landed, W::kGamma\);"
         r"\n *for \(int cb = 0;.*?&gamma_landed\);", ""),
        (r"\n *if \(j == 0\) hop::mbar_wait\(&gamma_landed, 0\);", "")])
    libs = {"kernel": gdn._load("gdn_fwd.cu"),
            "without gamma's load": no_gamma}
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for C in (192, 128):
        for inverse in (False, True):
            us = {k: [] for k in libs}
            for k in ks:
                n = 64 * k * sms
                x, beta, gamma, _ = chip_smoke._gdn_inputs(
                    gen, n, C, torch.bfloat16)
                y = torch.empty_like(x)
                for which, lib in libs.items():
                    def call(lib=lib):
                        if lib.lmic_gdn_fwd(x.data_ptr(), gamma.data_ptr(),
                                            beta.data_ptr(), y.data_ptr(),
                                            n, C, 1, int(inverse), None,
                                            stream):
                            raise RuntimeError(f"gdn-fwd-tiles {which}")
                    us[which].append(1e3 * _time_ms(call))
                del x, beta, gamma, y
            for which, v in us.items():
                b, a = np.polyfit(ks, v, 1)
                key = f"C={C} {'IGDN' if inverse else 'GDN'} {which}"
                out[key] = {"us": dict(zip(map(str, ks), v)),
                            "a_us": float(a), "b_us": float(b)}
                log(f"gdn-fwd-tiles {key}: "
                    + ", ".join(f"{k} tiles/SM {u:.2f}"
                                for k, u in zip(ks, v))
                    + f" us; line {a:.2f} + {b:.3f} k us")
    log("gdn-fwd-tiles: " + json.dumps({"sms": sms, **out}))


def gdn_fwd_sqrt(rows=(262_144, 65_536, 16_384, 16_391, 1_572_864)):
    """gdn-fwd-sqrt: the wide kernel's IGDN against a copy built with IEEE
    sqrtf in its epilogue: differing output elements and device µs."""
    import torch

    from lmic_tpu_torch.ops import gdn

    ieee = _patched([
        (r"float s = rsqrtf\(norm\);\n *if \(kInverse\) s = "
         r"hop::sqrt_from_rsqrt\(norm, s\);\n",
         "const float s = kInverse ? sqrtf(norm) : rsqrtf(norm);\n")])
    libs = {"kernel": gdn._load("gdn_fwd.cu"), "IEEE sqrtf": ieee}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out, total, differ = {}, 0, 0
    for C in (192, 128):
        for n in rows:
            x, beta, gamma, _ = chip_smoke._gdn_inputs(
                gen, n, C, torch.bfloat16)
            ys = {k: torch.empty_like(x) for k in libs}
            calls = {}
            for which, lib in libs.items():
                def call(lib=lib, y=ys[which]):
                    if lib.lmic_gdn_fwd(x.data_ptr(), gamma.data_ptr(),
                                        beta.data_ptr(), y.data_ptr(), n, C,
                                        1, 1, None, stream):
                        raise RuntimeError(f"gdn-fwd-sqrt {which}")
                calls[which] = call
                call()
            torch.cuda.synchronize()
            diff = int((ys["kernel"] != ys["IEEE sqrtf"]).sum())
            total, differ = total + x.numel(), differ + diff
            us = {k: [] for k in libs}
            for order in (list(libs), list(libs)[::-1]):
                for which in order:
                    us[which].append(1e3 * _time_ms(calls[which]))
            key = f"{n}x{C}"
            out[key] = {"differ": diff, "elements": x.numel(), "us": us}
            log(f"gdn-fwd-sqrt {key} IGDN: {diff} of {x.numel()} elements "
                "differ; " + ", ".join(
                    f"{k} {min(v):.1f}-{max(v):.1f} us"
                    for k, v in us.items()))
            del x, beta, gamma, ys
    log(f"gdn-fwd-sqrt: {differ} of {total} elements differ; "
        + json.dumps(out))


STREAM_VARIANTS = {
    "2 stages": [(r"kStreamStages = 3;", "kStreamStages = 2;")],
    "4 stages, 1 output tile": [(r"kStreamStages = 3;", "kStreamStages = 4;"),
                                (r"kStreamTiles = 2;", "kStreamTiles = 1;")],
    "f32 products": [(r"\*p = hop::mul2\(xw, bits2\((.*?)\)\);",
                      r"const unsigned sw = bits2(\1); *p = bits2("
                      r"__floats2bfloat162_rn(__uint_as_float(xw << 16) * "
                      r"__uint_as_float(sw << 16), __uint_as_float(xw & "
                      r"0xffff0000u) * __uint_as_float(sw & 0xffff0000u)));")],
    "no setmaxnreg": [(r"\n *hop::setmaxnreg_dec<kStreamProducerRegs>\(\);",
                       ""),
                      (r"\n *hop::setmaxnreg_inc<kStreamConsumerRegs>\(\);",
                       "")],
}
# timing only (their outputs are wrong): without the products, and with
# the epilogue storing x as y
STREAM_TIMING = {
    "no products": [(r"hop::wgmma_rs<64 \* kB>\(.*?\);", "")],
    "no epilogue arithmetic": [
        (r"\*p = hop::mul2\(xw, bits2\(.*?\)\);", "*p = xw;")],
}


def gdn_fwd_stream(shapes=((262_144, 320), (262_144, 256), (16_391, 320),
                           (16_391, 1024))):
    """gdn-fwd-stream: gdn_fwd_stream_kernel against copies built with
    STREAM_VARIANTS' rings: device µs in turns, equal outputs."""
    import torch

    from lmic_tpu_torch.ops import gdn

    libs = {"kernel": gdn._load("gdn_fwd.cu")}
    libs.update({k: _patched(v) for k, v in
                 {**STREAM_VARIANTS, **STREAM_TIMING}.items()})
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for n, C in shapes:
        x, beta, gamma, _ = chip_smoke._gdn_inputs(gen, n, C, torch.bfloat16)
        ys = {k: torch.empty_like(x) for k in libs}
        calls = {}
        for which, lib in libs.items():
            def call(lib=lib, y=ys[which]):
                if lib.lmic_gdn_fwd(x.data_ptr(), gamma.data_ptr(),
                                    beta.data_ptr(), y.data_ptr(), n, C, 1,
                                    0, None, stream):
                    raise RuntimeError(f"gdn-fwd-stream {which}")
            calls[which] = call
            call()
        torch.cuda.synchronize()
        for which, y in ys.items():
            if which not in STREAM_TIMING and not torch.equal(y,
                                                              ys["kernel"]):
                raise AssertionError(f"gdn-fwd-stream {which} {n}x{C}: "
                                     "other bytes than the kernel's")
        us = {k: [] for k in libs}
        for order in (list(libs), list(libs)[::-1]):
            for which in order:
                us[which].append(1e3 * _time_ms(calls[which]))
        out[f"{n}x{C}"] = us
        log(f"gdn-fwd-stream {n}x{C} GDN: " + ", ".join(
            f"{k} {min(v):.1f}-{max(v):.1f} us" for k, v in us.items()))
        del x, beta, gamma, ys
    log("gdn-fwd-stream: " + json.dumps(out))


DX_STREAM_VARIANTS = {
    "2 stages": [(r"kDsStages = 3;", "kDsStages = 2;")],
    "workspace read after the products": [
        (r"(  float4 gs\[8 \* kB\];\n#pragma unroll\n  for .*? gs\[i\] = "
         r"\*ds_work_at\(work, i\);\n)(  float acc\[32 \* kB\];\n  "
         r"ds_dn_loop<kB>\(.*?\);\n)", r"\2\1")],
    "workspace through L2 only": [
        (r"\*ds_work_at\(work, i\) = (make_float4\(.*?\));",
         r"__stcg(ds_work_at(work, i), \1);"),
        (r"gs\[i\] = \*ds_work_at\(work, i\);",
         "gs[i] = __ldcg(ds_work_at(work, i));")],
}
# timing only (their outputs are wrong): without the products, without
# the elementwise arithmetic of either pass, without the workspace
DX_STREAM_TIMING = {
    "no products": [(r"hop::wgmma_rs<64 \* kB>\(.*?\);", ""),
                    (r"hop::wgmma_ss<64 \* kB, 1>\(.*?\);", "")],
    "no epilogue arithmetic": [
        (r"(ds_elementwise\(float norm.*?\{\n)  const float rs = "
         r"rsqrtf\(norm\);.*?\n  \}\n", r"\1  *d = gv;\n  *sg = xv + norm;\n"),
        (r"\*p = hop::pack2\(\(h \? s\.z.*?\);", "*p = xw;")],
    "no workspace": [
        (r"\*ds_work_at\(work, i\) = make_float4\(.*?\);", "(void)gs;"),
        (r"gs\[i\] = \*ds_work_at\(work, i\);",
         "gs[i] = make_float4(0.f, 0.f, 0.f, 0.f);")],
}


def gdn_dx_stream(shapes=((262_144, 320), (262_144, 256), (16_391, 320),
                          (16_391, 1024))):
    """gdn-dx-stream: bf16 gdn_bwd_dx on gdn_bwd_dx_stream_kernel (GDN)
    against copies built as DX_STREAM_VARIANTS and DX_STREAM_TIMING say:
    device µs in turns; the variants' dx, dn and tile sums against the
    kernel's (equal bytes, or within the bf16 bar)."""
    import torch

    from lmic_tpu_torch.ops import gdn

    edits = {**DX_STREAM_VARIANTS, **DX_STREAM_TIMING}
    with ThreadPoolExecutor(len(edits)) as pool:  # one compiler each
        built = pool.map(lambda e: _patched(e, "gdn_bwd.cu"), edits.values())
        libs = {"kernel": gdn._load("gdn_bwd.cu"), **dict(zip(edits, built))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for n, C in shapes:
        x, beta, gamma, g = chip_smoke._gdn_inputs(gen, n, C, torch.bfloat16)
        outs, calls = {}, {}
        for which, lib in libs.items():
            dx = torch.empty_like(x)
            dn, sums = gdn._dn_scratch(lib, n, C, x.dtype, "cuda")
            nbytes = lib.lmic_gdn_bwd_dx_scratch_bytes(
                x.data_ptr(), g.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
                dn.data_ptr(), n, C, 1)
            scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")

            def call(lib=lib, dx=dx, dn=dn, sums=sums, scratch=scratch):
                if lib.lmic_gdn_bwd_dx(
                        x.data_ptr(), g.data_ptr(), None, gamma.data_ptr(),
                        beta.data_ptr(), dx.data_ptr(), dn.data_ptr(),
                        sums.data_ptr(), n, C, 1, 0, scratch.data_ptr(),
                        stream):
                    raise RuntimeError(f"gdn-dx-stream {which}")
            outs[which], calls[which] = (dx, dn, sums), call
            call()
        torch.cuda.synchronize()
        same = {}
        for which in DX_STREAM_VARIANTS:
            same[which] = all(torch.equal(a, b) for a, b in
                              zip(outs[which], outs["kernel"]))
            _, rel = chip_smoke._errors(outs[which], outs["kernel"])
            if not rel < chip_smoke.TOL["bfloat16"]:
                raise AssertionError(f"gdn-dx-stream {which} {n}x{C}: "
                                     f"error {rel:.3g}")
        us = {k: [] for k in libs}
        for order in (list(libs), list(libs)[::-1]):
            for which in order:
                us[which].append(1e3 * _time_ms(calls[which]))
        out[f"{n}x{C}"] = {"us": us, "equal_bytes": same}
        log(f"gdn-dx-stream {n}x{C} GDN: " + ", ".join(
            f"{k} {min(v):.1f}-{max(v):.1f} us" for k, v in us.items())
            + f"; the same bytes as the kernel: {same}")
        del x, beta, gamma, g, outs, calls
    log("gdn-dx-stream: " + json.dumps(out))


# gdn-f32-blocked's variants of the blocked f32 kernels: (source, edits)
# of each: a tile shape as the Config of csrc/gdn_fwd.cu's FwdBlocked and
# csrc/gdn_bwd.cu's DxBlocked names it (warp rows, warp columns, a
# thread's columns), or a constant of csrc/gdn_f32.cuh's blocked loop
F32_FWD_CONFIG = r"using FwdBlocked = f32::blocked::Config<.*?>;"
F32_DX_CONFIG = r"using DxBlocked = f32::blocked::Config<.*?>;"


def _config(which, args):
    name = "FwdBlocked" if which == "fwd" else "DxBlocked"
    return [(F32_FWD_CONFIG if which == "fwd" else F32_DX_CONFIG,
             f"using {name} = f32::blocked::Config<{args}>;")]


def _constant(name, value):
    return [("gdn_f32.cuh", rf"constexpr int {name} = \d+;",
             f"constexpr int {name} = {value};")]


F32_BLOCKED_VARIANTS = {
    part: {"3 stages": _constant("kMaxStages", 3),
           "2 stages": _constant("kMaxStages", 2),
           "1 step unrolled": _constant("kUnroll", 1),
           "a slice unrolled whole": _constant("kUnroll", 8),
           # a thread's 8 rows consecutive: the four quarter warps' rows
           # alike mod 8, their units of a on one bank quad
           "consecutive rows": _constant("kRowGap", 1) + [
               ("gdn_f32.cuh", r"return \{wr \* 32 \+ lane / 8,",
                "return {wr * 32 + lane / 8 * kRowsT,")],
           "128 x 128 tiles, 8 x 8 a thread": _config(part, "4, 2, 8"),
           "64 x 256 tiles, 8 x 8 a thread": _config(part, "2, 4, 8")}
    for part in ("fwd", "dx")}
# the routes: the forward's small tiles never or always, 256-column
# blocks at every C, and dx without clusters
F32_SMALL_RULE = (r"return 100 \* wave_sums<FwdBlockedSmall>.*?;",)
F32_BLOCKED_VARIANTS["fwd"]["no small tiles"] = [(*F32_SMALL_RULE,
                                                  "return false;")]
F32_BLOCKED_VARIANTS["fwd"]["small tiles"] = [(*F32_SMALL_RULE,
                                               "return true;")]
# ... and two of their CTAs an SM (a ring of 4 stages each)
F32_BLOCKED_VARIANTS["fwd"]["small tiles, 2 CTAs an SM"] = [
    (*F32_SMALL_RULE, "return true;"),
    (r"using FwdBlockedSmall = f32::blocked::Config<.*?>;",
     "using FwdBlockedSmall = f32::blocked::Config<2, 4, 4, 2>;")]
F32_BLOCKED_VARIANTS["fwd"]["no 128-column blocks"] = [
    (r"blk::narrow_blocks\(width\) \|\| !vec_y", "!vec_y")]
F32_BLOCKED_VARIANTS["dx"]["no 128-column blocks"] = [
    (r": blk::narrow_blocks\(width\)", ": false")]
F32_BLOCKED_VARIANTS["dx"]["no clusters"] = [
    (r"k <= 8 && k <= blocks; k \*= 2", "k <= 1; k *= 2")]
# the forward's IGDN with IEEE sqrtf in place of its Newton step from
# rsqrtf
F32_BLOCKED_SQRT = [(r"kInverse \? hop::sqrt_from_rsqrt\(norm, rs\)",
                     "kInverse ? sqrtf(norm)")]
# the whole-width route's C (up to 384) on the blocked kernels too
F32_BLOCKED_ROUTE = {
    "fwd": [(r"if \(C > f32::kWholeWidth\)\n    return launch_blocked",
             "if (C > 0)\n    return launch_blocked")],
    "dx": [(r"if \(C > f32::kWholeWidth\)\n    return launch_dx_blocked",
            "if (C > 0)\n    return launch_dx_blocked")],
}
F32_BLOCKED_SHAPES = ((262_144, 512), (16_391, 512), (16_391, 1024),
                      (16_391, 2048), (16_391, 385), (16_391, 640),
                      (24_576, 512), (12_288, 512), (8_192, 512),
                      (6_144, 512), (4_096, 512), (4_096, 2048),
                      (1_000, 2048), (129, 2048))
F32_WHOLE_SHAPES = ((262_144, 192), (262_144, 128), (98_304, 192))


def _f32_call(lib, part, x, beta, gamma, gamma_t, g, inverse, out):
    """A call of `lib`'s f32 gdn_fwd (part "fwd") or gdn_bwd_dx ("dx")
    through its C ABI on buffers of its own, which it fills: out[0] y, or
    out[0] dx and out[1] dn."""
    import torch

    n, C = x.shape
    stream = torch.cuda.current_stream().cuda_stream
    if part == "fwd":
        nbytes = lib.lmic_gdn_fwd_scratch_bytes(
            x.data_ptr(), gamma_t.data_ptr(), out[0].data_ptr(), n, C, 0)
    else:
        nbytes = lib.lmic_gdn_bwd_dx_scratch_bytes(
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), n, C, 0)
    scratch = torch.empty(max(nbytes, 16), dtype=torch.uint8, device="cuda")

    def call():
        if part == "fwd":
            err = lib.lmic_gdn_fwd(x.data_ptr(), gamma_t.data_ptr(),
                                   beta.data_ptr(), out[0].data_ptr(), n, C,
                                   0, int(inverse), scratch.data_ptr(),
                                   stream)
        else:
            err = lib.lmic_gdn_bwd_dx(
                x.data_ptr(), g.data_ptr(), gamma_t.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), out[0].data_ptr(),
                out[1].data_ptr(), None, n, C, 0, int(inverse),
                scratch.data_ptr(), stream)
        if err:
            raise RuntimeError(f"gdn-f32-blocked {part}: error {err}")
    return call


def _clocks_during(fn, seconds=3.0):
    """The card's SM clock (MHz), its maximum and the power draw (W), as
    nvidia-smi samples them every 100 ms while `fn` runs back to back for
    about `seconds`: medians of the samples taken under the load."""
    import torch

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(8):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    rows = [[float(v) for v in line.split(",")]
            for line in out.strip().splitlines()[2:-1] if line.strip()]
    if not rows:
        return {}
    clock, top, watts = (float(np.median([r[i] for r in rows]))
                         for i in range(3))
    return {"sm_mhz": clock, "max_sm_mhz": top, "power_w": watts,
            "samples": len(rows)}


def gdn_f32_blocked():
    """gdn-f32-blocked: the blocked f32 kernels against copies built as
    F32_BLOCKED_VARIANTS says, at F32_BLOCKED_SHAPES (GDN), in turns:
    device µs of each and their outputs, which must be equal byte for
    byte (every variant keeps each sum's order); then, for information,
    the whole-width C of F32_WHOLE_SHAPES routed to the blocked kernels
    against gdn_fwd_kernel and gdn_bwd_dx_kernel (µs, and whether the
    bytes are equal)."""
    import torch

    from lmic_tpu_torch.ops import gdn

    sources = {"fwd": "gdn_fwd.cu", "dx": "gdn_bwd.cu"}
    jobs = [(part, name, edits) for part, v in F32_BLOCKED_VARIANTS.items()
            for name, edits in v.items()]
    jobs += [(part, "routed", edits)
             for part, edits in F32_BLOCKED_ROUTE.items()]
    jobs.append(("fwd", "IEEE sqrtf", F32_BLOCKED_SQRT))
    with ThreadPoolExecutor(8) as pool:  # one compiler each
        built = list(pool.map(lambda j: _patched(j[2], sources[j[0]]),
                              jobs))
    libs = {part: {"kernel": gdn._load(src)} for part, src in sources.items()}
    routed = {"routed": {}}
    for (part, name, _), lib in zip(jobs, built):
        kernel = ("gdn_fwd_f32_blocked_kernel" if part == "fwd"
                  else "gdn_bwd_dx_f32_blocked_kernel")
        log(f"gdn-f32-blocked {part} {name}: ptxas {_spills(lib, kernel)}")
        if name == "routed":
            routed[name][part] = lib
        elif name == "IEEE sqrtf":
            routed[name] = lib
        else:
            libs[part][name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}

    def race(part, group, n, C, inverse=False):
        x, beta, gamma, g = chip_smoke._gdn_inputs(gen, n, C, torch.float32)
        gamma_t = gamma.t().contiguous()
        outs, calls = {}, {}
        for which, lib in group.items():
            bufs = [torch.empty_like(x) for _ in range(2)]
            calls[which] = _f32_call(lib, part, x, beta, gamma, gamma_t, g,
                                     inverse, bufs)
            calls[which]()
            outs[which] = bufs if part == "dx" else bufs[:1]
        torch.cuda.synchronize()
        same = {k: all(torch.equal(a, b) for a, b in
                       zip(v, outs["kernel"])) for k, v in outs.items()}
        us = {k: [] for k in group}
        for order in (list(group), list(group)[::-1]):
            for which in order:
                us[which].append(1e3 * chip_smoke._time_ms(calls[which]))
        del x, beta, gamma, g, gamma_t, outs, calls
        torch.cuda.empty_cache()
        return us, same

    # the SM clock and power under each kernel's load: 67 TFLOP/s FP32
    # assumes the boost clock
    for part in ("fwd", "dx"):
        x, beta, gamma, g = chip_smoke._gdn_inputs(gen, 262_144, 512,
                                                   torch.float32)
        bufs = [torch.empty_like(x) for _ in range(2)]
        clocks = _clocks_during(_f32_call(
            libs[part]["kernel"], part, x, beta, gamma,
            gamma.t().contiguous(), g, False, bufs))
        out[f"{part} 262144x512 clocks"] = clocks
        log(f"gdn-f32-blocked {part} 262144x512 under load: "
            + json.dumps(clocks))
        del x, beta, gamma, g, bufs
        torch.cuda.empty_cache()
    for n, C in F32_BLOCKED_SHAPES[:5]:  # the forward's IGDN epilogue
        us, same = race("fwd", {"kernel": libs["fwd"]["kernel"],
                                "IEEE sqrtf": routed["IEEE sqrtf"]},
                        n, C, inverse=True)
        us["GDN"] = race("fwd", {"kernel": libs["fwd"]["kernel"]}, n, C)[0][
            "kernel"]
        out[f"fwd {n}x{C} IGDN"] = {"us": us, "same_bytes": same}
        log(f"gdn-f32-blocked fwd {n}x{C} IGDN: " + ", ".join(
            f"{k} {min(v):.1f}-{max(v):.1f} us" for k, v in us.items())
            + f"; the same bytes: {same['IEEE sqrtf']}")
    for part in ("fwd", "dx"):
        for n, C in F32_BLOCKED_SHAPES:
            us, same = race(part, libs[part], n, C)
            if not all(same.values()):
                raise AssertionError(f"gdn-f32-blocked {part} {n}x{C}: "
                                     f"other bytes than the kernel's {same}")
            out[f"{part} {n}x{C}"] = us
            log(f"gdn-f32-blocked {part} {n}x{C} GDN: " + ", ".join(
                f"{k} {min(v):.1f}-{max(v):.1f} us" for k, v in us.items()))
        for n, C in F32_WHOLE_SHAPES:
            us, same = race(part, {"kernel": libs[part]["kernel"],
                                   "blocked loop": routed["routed"][part]},
                            n, C)
            out[f"{part} {n}x{C} routed"] = {"us": us, "same_bytes": same}
            log(f"gdn-f32-blocked {part} {n}x{C} GDN, whole-width kernel "
                "against the blocked loop: " + ", ".join(
                    f"{k} {min(v):.1f}-{max(v):.1f} us"
                    for k, v in us.items())
                + f"; the same bytes: {same['blocked loop']}")
    log("gdn-f32-blocked: " + json.dumps(out))


def bf16_step():
    """bf16-step: a narrow `--bf16` step on the card against the CPU, with
    the rounded operands in TF32 (the port's route) and in FP32."""
    import contextlib

    from lmic_tpu_torch.ops import precision

    def compare(what, a, b):
        loss, whole, rms, worst = _step_gap(a, b)
        log(f"bf16-step {what}: losses within {loss:.3g}, gradients as one "
            f"vector {whole:.3g}, each leaf's relative error's root mean "
            f"square {rms:.3g}; worst leaves " + json.dumps(worst))

    cpu32 = _narrow_step("cpu", None)
    cpu16 = _narrow_step("cpu", "bfloat16")
    compare("card vs CPU, f32", _narrow_step("cuda", None), cpu32)
    compare("card vs CPU, --bf16 (TF32 on the rounded operands)",
            _narrow_step("cuda", "bfloat16"), cpu16)
    tf32 = precision._tf32
    precision._tf32 = lambda t: contextlib.nullcontext()
    try:
        compare("card vs CPU, --bf16 (the rounded operands in FP32)",
                _narrow_step("cuda", "bfloat16"), cpu16)
    finally:
        precision._tf32 = tf32
    compare("the rounding's effect: CPU --bf16 vs CPU f32", cpu16, cpu32)


def amp_narrow(widths=((40, 48), (32, 48), (192, 48))):
    """amp-narrow: the narrow AMP step on the card against the CPU, with
    the GDN kernels and with the plain versions on the card."""
    import torch

    from lmic_tpu_torch.ops import gdn

    bf16 = torch.bfloat16
    for N, M in widths:
        card = _narrow_step("cuda", None, bf16, N=N, M=M)
        card_f32 = _narrow_step("cuda", None, None, N=N, M=M)
        cpu = _narrow_step("cpu", None, bf16, N=N, M=M)
        cpu_f32 = _narrow_step("cpu", None, None, N=N, M=M)
        kernels = (gdn.gdn_fwd, gdn.gdn_bwd)
        gdn.gdn_fwd, gdn.gdn_bwd = gdn.gdn_reference, gdn.gdn_bwd_reference
        try:
            plain = _narrow_step("cuda", None, bf16, N=N, M=M)
        finally:
            gdn.gdn_fwd, gdn.gdn_bwd = kernels

        def worst(run, ref):
            loss, leaves = chip_smoke._amp_leaf_gaps(run, ref, card_f32,
                                                     cpu_f32)
            top = sorted(leaves.items(), key=lambda kv: -kv[1][0] / kv[1][1])
            return {"loss": loss, "whole": _step_gap(run, ref)[1],
                    "leaves (error, bar)": {k: [round(e, 5), round(b, 5)]
                                            for k, (e, b) in top[:4]}}

        def fro(a, b):
            return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()

        # the hyper-path leaves over the CPU AMP test's bar there
        # (tests/test_torch_train.py: 2e-2 + twice the CPU's AMP effect)
        over = {n: [round(fro(card[1][n], b), 5),
                    round(2e-2 + 2 * fro(b, cpu_f32[1][n]), 5)]
                for n, b in cpu[1].items()
                if n.startswith(("h_a.", "h_s.")) and fro(card[1][n], b)
                >= 2e-2 + 2 * fro(b, cpu_f32[1][n])}
        log(f"amp-narrow N = {N}, M = {M}: " + json.dumps({
            "kernels vs the CPU": worst(card, cpu),
            "over the CPU test's hyper-path bar (error, bar)": over,
            "plain versions on the card vs the CPU": worst(plain, cpu),
            "kernels vs the plain versions on the card": worst(card,
                                                               plain)}))


def wide_steps(steps=4):
    """wide-steps: phase 18's wide AMP model stepped from its init with
    the GDN kernels and with the plain versions, in AMP and in f32."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    cs = chip_smoke
    batch = cs._train_batch(cs.WIDE_AMP_BATCH, seed=1)
    for dtype in (torch.bfloat16, None):
        for plain in (False, True):
            kernels = (gdn.gdn_fwd, gdn.gdn_bwd)
            if plain:
                gdn.gdn_fwd, gdn.gdn_bwd = (gdn.gdn_reference,
                                            gdn.gdn_bwd_reference)
            try:
                module = zoo.create_model(cs.TRAIN_ARCH, cs.TRAIN_QUALITY,
                                          seed=0, device="cuda",
                                          dtype=dtype, **cs.WIDE_AMP).module
                opt = make_optimizer()
                state = create_train_state(module, opt)
                step = make_train_step(module, opt, cs.TRAIN_LAMBDA)
                gen = torch.Generator(device="cuda").manual_seed(0)
                losses = [float(step(state, batch, gen)[1]["loss"])
                          for _ in range(steps)]
            finally:
                gdn.gdn_fwd, gdn.gdn_bwd = kernels
            log(f"wide-steps {cs.WIDE_AMP} {'amp' if dtype else 'f32'} "
                f"{'plain versions' if plain else 'kernels'}: losses "
                + json.dumps([round(v, 2) for v in losses]))
            del module, opt, state, step
            torch.cuda.empty_cache()


def main(argv):
    import torch

    probes = ("master-batch", "train-convs", "video-convs", "sync-u8",
              "gdn-ab", "gdn-host", "gdn-fwd-tiles", "gdn-fwd-sqrt",
              "gdn-fwd-stream", "gdn-dx-stream", "gdn-f32-blocked",
              "bf16-step", "amp-narrow", "wide-steps")
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
    elif argv[0] == "gdn-ab":
        roots = [a for a in argv[1:] if a != "--off-route"]
        gdn_ab(roots or [os.path.dirname(os.path.abspath(__file__))],
               "--off-route" in argv[1:])
    elif argv[0] == "gdn-host":
        gdn_host(os.path.abspath(argv[1]))
    elif argv[0] == "gdn-fwd-tiles":
        gdn_fwd_tiles()
    elif argv[0] == "gdn-fwd-sqrt":
        gdn_fwd_sqrt()
    elif argv[0] == "gdn-fwd-stream":
        gdn_fwd_stream()
    elif argv[0] == "gdn-dx-stream":
        gdn_dx_stream()
    elif argv[0] == "gdn-f32-blocked":
        gdn_f32_blocked()
    elif argv[0] == "bf16-step":
        bf16_step()
    elif argv[0] == "amp-narrow":
        amp_narrow()
    elif argv[0] == "wide-steps":
        wide_steps()
    else:
        video_convs()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
