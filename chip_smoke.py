#!/usr/bin/env python3
"""On-card smoke run of lmic_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py                 # from the root of a checkout, one GPU
    python3 chip_smoke.py --kernels-only  # phases 1 and 2 alone, no result

Phases, each of which raises (exit code != 0) on any failure:

1. environment: the card's name and power limit, the torch/CUDA/nvcc
   versions; the port's native sources are built, all at once; each GDN
   kernel's registers and spills from ptxas (a register-tiled f32 kernel
   must not spill); the count of tensor-core (HMMA) instructions in each
   GDN kernel, from `cuobjdump -sass`: every bf16 product kernel must have
   some, and no f32 kernel any (that would be TF32);
2. kernels: the CUDA GDN forward (`gdn_fwd`) and backward (`gdn_bwd`,
   three launches) against their plain versions on the card at the main
   paths' shapes (serving: 98,304 / 24,576 / 6,144 / 6,151 rows; training:
   262,144 / 65,536 / 16,384 / 16,391 rows), C in {128, 192}, f32 and bf16,
   and the RGB-T pair's f32 rows at C = 192 (327,680 / 327,687 / 81,920 /
   20,480 / 5,120; `gdn_bwd` too at the master step's 327,680 / 327,687 /
   81,920 / 20,480; `gdn_fwd` too at the master step's frozen guide,
   1,310,720 / 1,310,727, and at phase 12's batched synthesis, 393,216 /
   1,572,864), both directions, each deterministic (f32 `gdn_fwd`
   exactly equal to its plain version), with CUDA-event timings of the
   kernel, the plain version and a cuBLAS composite of the same math,
   beside the least time the card could take; then each of the backward's
   launches (`gdn_bwd_dx`, `gdn_bwd_partials`, `gdn_bwd_reduce`) on its
   own, against its own plain version, bound and library call (the dx
   composite, one cuBLAS `bmm` of the partials' chunked product, `sum(0)`
   of the partials);
3. serving: mbt2018-mean at quality 8 (N=192, M=320) from a seed, served by
   the port's HTTP server; three seeded 512x768 uint8 images go through
   POST /compress and /decompress with the launch counts set to 0 just
   before and read just after; then the decoded bytes are held to the
   direct codec calls, encoding to be deterministic, decoding to recover
   exactly the encoded latents, and the CUDA transforms to the CPU
   plain-version transforms on a small input;
4. the other archs: one direct round trip each of bmshj2018-factorized and
   bmshj2018-hyperprior at quality 8, 512x768;
5. training: mbt2018-mean at quality 7 (N=192, M=320, lambda 10240), the
   widest model lmic_tpu's trainer takes, from a seed, batch 16 of seeded
   256x256 images: timed steps in f32 and in bf16 AMP with the launch
   counts set to 0 just before and read just after (6 forward and 6 of
   each backward kernel per step), the loss falling on one batch (over 10
   steps in f32, 6 in AMP), a
   profile of the GDN kernels' share, one step's gradients on the card
   against the CPU on a narrow model with the same noise, and the trained
   model saved, reloaded, finalized and round-tripped through the codec;
6. AR serving: mbt2018 at quality 8 (N=192, M=320) from a seed, served
   by the port's HTTP server, three seeded 512x768 images through POST
   /compress and /decompress with the launch counts set to 0 just before
   and read just after (6 forward launches a round trip, no backward); the
   bodies held to the direct codec calls, encoding to be deterministic,
   the decoder to recover exactly the encoder's latents, the CUDA
   transforms and one image's wavefront scales and means to the CPU
   plain path on a small input; the stages of `codec.stats` logged (the
   decode loop split into device work and host rANS); then one direct
   512x768 round trip each of cheng2020-anchor at quality 3 (N=128) and
   cheng2020-attn at quality 6 (N=192), with the same checks, each
   round trip's profile, and cuDNN against the conv route of
   `layers.Conv` on cheng2020's 192-channel 3x3 conv. It runs last, so
   that training is measured in the process state it had before the
   phase existed (run before it, the phase raised training's f32 peak
   memory by 0.10 GiB);
7. RGB-T serving: the paper's guided/master pair at quality 7 (N = M =
   192) from a seed, channel 1, served by the port's HTTP server: three
   seeded pairs of a 512x640 thermal master and a 1024x1280 RGB guide
   through POST /compress (9 `gdn_fwd` launches: the guide's g_a and its
   one-pass reconstruct, the master's g_a) and POST /decompress with the
   guide cached (3: the master's g_s), the launch counts set to 0 just
   before and read just after; the bodies held to the direct calls,
   encoding to be deterministic, the master's decoder to recover exactly
   the encoder's latents, the guide's reconstruct to equal its decompress
   bit for bit, the CUDA transforms to the CPU's on a small input; the
   stages, peak memory and each leg's largest kernels logged; then one
   direct channel-3 round trip (a 1024x1280 RGB master, a 512x640 thermal
   guide) with the same checks;
8. AR and RGB-T training, last, so the earlier phases keep the process
   state they were measured in: a 3x3 conv forward and backward through
   cuDNN, as the step runs it, at the training shapes at risk of its FFT
   engine (192 -> 192 at 128x128, batch 16; 256 -> 256 at 512x640, batch
   4), logged; mbt2018 q7,
   cheng2020-anchor q3, cheng2020-attn q6 and guided q7 (first conv at
   stride 2) from seeds at batch 16 of 256x256, f32 and AMP, then the
   channel-1 master q7 against its frozen guide (f32, batch 4 of 512x640
   thermal masters with 1024x1280 RGB guides; lmic_tpu's batch of 16 does
   not fit): each 2 warm-up and 4 timed steps with the launch counts set
   to 0 just before and read just after (6 `gdn_fwd` and 6 of each
   backward kernel a step; the master 12 and 6), the loss falling on one
   batch, step ms, peak memory and a profile of one step logged; then a
   narrow cheng2020-attn step and a narrow master step on the card
   against the CPU with the same noise;
9. the paired RGB-T archs, next, so every earlier phase keeps the process
   state it was measured in: one direct round trip of each `_R` -> `_D`
   pair (mbt2018, cheng2020-anchor, cheng2020-attn) at quality 7 (N = M =
   192), seed 0 for the guide and 1 for the thermal codec, a 512x640 RGB
   guide and a 512x640 thermal image (lmic_tpu's paired-eval geometry),
   with the launch counts set to 0 just before and read just after (15
   `gdn_fwd` a pair: 6 for the `_R` compress, whose ga* maps take a second
   analysis pass, then 3 for each other leg; no backward); encoding
   deterministic, each decoder recovering exactly its encoder's latents,
   the CUDA transforms within 1e-4 of the CPU's on a small input with
   equal tables; each leg's stages, ms and peak memory logged, with a
   profile of each leg of the first pair and of the others' round trips,
   and the first fusion conv on the GEMM route; then cheng2020-attn_R q7
   trained in f32 at batch 16 of 256x256 (2 warm-up and 4 timed steps, 6
   `gdn_fwd` and 6 of each backward kernel a step, the loss falling);
10. video serving, last: ssf2020 (192 latent, 128 mid planes, its one
   width) from seed 0, finalized by `update_model_file` and served by
   `serve.main --checkpoint ... -a ssf2020` in a thread; three seeded
   3-frame GOPs (an I and two P frames) of 1920x1152 uint8 (1080p padded
   to multiples of 128) through POST /compress and /decompress after one
   warm-up pair, with the launch counts set to 0 just before and read
   just after (ssf2020 has no GDN: all must read 0); each body equal to
   the direct call's and parsing back to itself, encoding deterministic,
   the decoder's frames equal to the encoder's in-loop reconstructions
   bit for bit, the uint8 frames within one level of the float decode,
   the CUDA transforms and the scale-space warp within 1e-4 of the CPU's
   stage by stage on a 128x128 GOP (`crosscheck.video_agreement`) with
   equal tables; each request's ms, stages, bytes and bpp per frame
   type, the peak memory, a profile of each leg and the 11x11 depthwise
   blur's kernels at full size logged;
11. evaluation and files, last: the eval functions of
   `utils/eval_model.py` on mbt2018-mean q8 (two seeded 512x768 images,
   6 `gdn_fwd` an image in each mode; the coder's bpp equal to 8 x the
   bytes of a direct compress; the card's estimate within 1e-4 of the
   CPU's on a 128x128 image), on the channel-1 RGB-T pair q7 (512x640
   master, 1024x1280 guide; 12 `gdn_fwd` with the coder, 9 to encode and
   3 to decode) and on the mbt2018_R -> mbt2018_D pair q7 at 512x640 (15
   with the coder); `video_eval.main` in both modes from a training
   checkpoint of ssf2020 seed 0 on a seeded 3-frame 1080p YUV420 clip
   (lmic_tpu's JSON schema; 0 GDN launches), then `codec_cli.main`
   encode/decode of the clip in both containers (the decoded planes equal
   to those of the encoder's in-loop frames); mbt2018-mean q8 in both
   containers, mbt2018 q8 in the reference one (the raster order) and the
   master pair in both (raster for the reference one) through the
   array-level cores, each file parsing back to its codec's strings and
   decoding to the encoder's latents and a direct decompress; the pair
   finalized by `update_model_file` and served by `serve.main -a master
   --guided-checkpoint --channel 1` in a thread, one pair through
   /compress and /decompress equal to the direct calls. The launch
   counts are set to 0 after one warm-up call of each eval leg and read
   at the end; each step's ms, the raster loops' ms per latent pixel, the
   ms-ssim's device ms at 512x768 and 1080p and the peak memory logged;
12. pipelines and bundles, last: mbt2018-mean, bmshj2018-hyperprior and
   bmshj2018-factorized at quality 8 from seed 0, batch 16 of 768x512
   uint8 (bench.py's bench_pipelined geometry): a synchronous loop of two
   batches, then bench_pipelined's loop of six (compress_async of batch
   i+1, the finalize of batch i, decompress_async of batch i) with
   LMIC_DECODE_THREAD off (and on too for mbt2018-mean), each batch's
   strings and pixels equal
   to the synchronous ones, 3 `gdn_fwd` launches an image to encode and
   3 a batch to decode, no backward; images/s of each loop, a
   synchronous batch's device ms, busy share and largest kernels, peak
   memory; then mbt2018 q8 (512x768) and one 3-frame 1920x1152 ssf2020
   GOP through their async pairs, equal to their synchronous calls (6 and
   0 `gdn_fwd`); then serving bundles exported on the card (utils/aot.py;
   seconds and MiB logged): mbt2018-mean q8 at 1x512x768 served by
   `serve.main --bundle` (three requests, bodies and pixels equal to the
   live codec's, 6 `gdn_fwd` a round trip), at 16x768x512 through the
   pipelined loop (equal to the live codec's batches), and ssf2020 at
   1x3x1152x1920 (equal to the live codec's GOP), each leg's peak memory
   logged; each mbt2018-mean bundle holds 3 `gdn_fwd` operator nodes in
   `_analyze_u8__one` and in each `_synth_u8` variant.
13. pretrained and remat, last: a CompressAI-format .pth.tar of
   mbt2018-mean q8 (N = 192, M = 320) from seed 0 with its baked tables
   (`crosscheck.write_reference_checkpoint`: the reference's buffers, a
   `module.` prefix, an old `_matrices.0` key), finalized on the card by
   `update_model_cli --from-torch` and served by `serve.main --checkpoint`
   in a thread: three seeded 512x768 images through POST /compress and
   /decompress with the launch counts set to 0 just before and read just
   after (6 `gdn_fwd` a round trip, no backward); the finalized tables
   equal to the file's buffers bit for bit, the bodies to the direct
   calls and the strings to the source codec's, encoding deterministic,
   the decoder recovering the encoder's latents; `--no-update` then
   `--raw-params` on the same file equal, byte for byte, to the plain
   finalization; one 3-frame 1920x1152 ssf2020 GOP through its own
   `--from-torch` file (the three sub-codecs' tables adopted, the
   source's strings, the decoder's frames the encoder's in-loop ones, 0
   GDN launches). Then training under --remat: mbt2018-mean q7 at batch
   16 of 256x256, f32 and AMP, a warm-up, a profiled and 4 timed steps
   with the launch counts set to 0 just before and read just after (12
   `gdn_fwd` and 6 of each backward kernel a step: every GDN runs again
   in its block's recompute), the loss falling, step ms and peak memory
   logged, and one step against the plain step under
   `crosscheck.fixed_noise` (losses and clipped gradients within the f32
   and bf16 bars, exact launch counts); then the channel-1 master q7
   under --remat against its frozen guide at lmic_tpu's batch of 16, with
   the caching allocator's expandable segments as `train_cli --remat`
   sets them (two steps, 18 `gdn_fwd` and 6 of each backward kernel the
   timed one; step ms, peak memory and the backward spans, from one
   block's recompute to the next, with the highest memory logged).

The next-to-last line of stdout is the kernels' JSON summary; the last is
{"ok": true, "device": {...}}. Without a GPU, or run from a directory that
does not hold the port, it exits non-zero and prints no result. With
--kernels-only it stops after phase 2 and prints the per-pass sums of the
kernel phase, never the "ok" line.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published peaks (NVIDIA data sheets, dense): bytes/s of device memory,
# FP32 FLOP/s outside the tensor cores, bf16 tensor-core FLOP/s.
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),  # SXM (HBM3)
}
# GDN rows (N*H*W) of the main paths: a q8 512x768 round trip (one image)
# and a training step (batch 16 of 256x256); the fourth of each is ragged
SERVE_ROWS = (98_304, 24_576, 6_144, 6_151)
TRAIN_ROWS = (262_144, 65_536, 16_384, 16_391)
# the RGB-T pair (channel 1, a 512x640 master and a 1024x1280 guide), f32,
# C = 192: the guide's first GDN at 327,680 rows (and a ragged count near
# it), and per round trip each of these rows in GDN and in IGDN this many
# times: compress = the guide's g_a and reconstruct, the master's g_a;
# decompress (guide cached) = the master's g_s
RGBT_ROWS = (327_680, 327_687, 81_920, 20_480, 5_120)
RGBT_ROUND_TRIP = {327_680: 1, 81_920: 2, 20_480: 2, 5_120: 1}
RGBT_QUALITY = 7
RGBT_MASTER = (1, 512, 640, 1)  # the reference's 512x640 thermal geometry
RGBT_GUIDE = (1, 1024, 1280, 3)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # as tests/test_pallas_gdn.py
IMAGE = (1, 512, 768, 3)  # Kodak geometry
SERVE_ARCH, QUALITY = "mbt2018-mean", 8
# the autoregressive family: mbt2018 served over HTTP, cheng2020 direct
AR_SERVE_ARCH, AR_QUALITY = "mbt2018", 8
AR_DIRECT = (("cheng2020-anchor", 3), ("cheng2020-attn", 6))
# lmic_tpu's trainer: batch 16, 256x256 patches (utils/train_cli.py), lambda
# table of 7 entries, so quality 7 is the widest trainable model
TRAIN_ARCH, TRAIN_QUALITY, TRAIN_LAMBDA = "mbt2018-mean", 7, 10240
TRAIN_BATCH = (16, 256, 256, 3)
# phase 8: the AR family and the RGB-T guide at lmic_tpu's trainer
# defaults (batch 16 of 256x256), f32 and AMP; quality -> lambda from the
# fork's table (lmic_tpu/utils/train.py)
AR_TRAIN = (("mbt2018", 7), ("cheng2020-anchor", 3), ("cheng2020-attn", 6),
            ("guided", 7))
LAMBDAS = (256, 512, 1024, 2048, 4096, 8192, 10240)
# the master (channel 1) against its frozen guide, f32: the reference's
# whole frames, a 512x640 thermal master with its 1024x1280 RGB guide;
# batch 4, cut from lmic_tpu's 16 (batch 16 does not fit in 80 GB)
MASTER_BATCH = (4, 512, 640, 1)
MASTER_GUIDE = (4, 1024, 1280, 3)
# f32 gdn_bwd at the master step's rows (C = 192): 327,680 / 81,920 /
# 20,480, and a ragged count beside the largest
MASTER_STEP_ROWS = (327_680, 81_920, 20_480)
MASTER_TRAIN_ROWS = MASTER_STEP_ROWS + (327_687,)
# f32 gdn_fwd in the master step's frozen guide (first conv at stride 2 on
# 1024x1280): its first GDN and last IGDN at 1,310,720 rows, and a ragged
# count beside it; per master step each of these rows runs in GDN and in
# IGDN this many times (the guide at 1,310,720 / 327,680 / 81,920, the
# master at 327,680 / 81,920 / 20,480)
MASTER_GUIDE_ROWS = (1_310_720, 1_310_727)
MASTER_STEP_FWD = {1_310_720: 1, 327_680: 2, 81_920: 2, 20_480: 1}
# phase 9: the paired RGB-T archs at quality 7 (N = M = 192), a same-size
# pair at lmic_tpu's paired-eval geometry (eval_model.py's --crop-size,
# 512x640): an RGB guide through the `_R` codec (first conv at stride 2),
# a thermal image through the `_D` codec
PAIRED = ("mbt2018", "cheng2020-anchor", "cheng2020-attn")
PAIRED_QUALITY = 7
PAIRED_GUIDE = (1, 512, 640, 3)
PAIRED_IMAGE = (1, 512, 640, 1)
# gdn_fwd launches a pair round trip, by leg: the `_R` compress (its
# analysis, then the ga* maps' second pass), the `_R` decompress, the `_D`
# compress and decompress; every one at 81,920 / 20,480 / 5,120 rows
PAIRED_LEGS = (6, 3, 3, 3)
PAIRED_ROUND_TRIP = {81_920: (3, 2), 20_480: (3, 2), 5_120: (3, 2)}
# one `_R` arch trained at lmic_tpu's trainer defaults, f32 (lmic_tpu's
# AMP_ARCHS leaves the `_R` archs out)
PAIRED_TRAIN = ("cheng2020-attn_R", 7)
# phase 10: ssf2020 (its one width: 192 latent, 128 mid planes) served from
# a finalized checkpoint, three 3-frame GOPs (an I and two P frames) of
# 1080p padded to multiples of 128, as lmic_tpu's video eval pads it
VIDEO_GOP = (1, 3, 1152, 1920, 3)
VIDEO_REQUESTS = 3
VIDEO_CHECK = (1, 3, 128, 128, 3)  # the CUDA-vs-CPU stages
# phase 11: evaluation and files
EVAL_QUALITY = 8  # mbt2018-mean and mbt2018 q8: N = 192, M = 320
EVAL_IMAGES = 2
EVAL_CHECK = (1, 128, 128, 3)  # the card's estimate against the CPU's
VIDEO_CLIP = (3, 1080, 1920)  # frames, H, W of the YUV420 clip
# phase 12: pipelines and bundles; bench.py's bench_pipelined geometry
PIPE_ARCHS = ("mbt2018-mean", "bmshj2018-hyperprior", "bmshj2018-factorized")
PIPE_BATCH = (16, 768, 512, 3)
PIPE_BATCHES = 6  # the pipelined loop's batches
# f32 gdn_fwd (C = 192) in a batch of 16 decoded at once: the batched
# synthesis's second and third IGDN (its first is at 98,304 rows, a serving
# row); per batch the analysis runs GDN per image at SERVE_ROWS[:3] and the
# synthesis runs IGDN once at each of its rows: (GDN times, IGDN times)
PIPE_ROWS = (393_216, 1_572_864)
PIPE_BATCH_FWD = {98_304: (16, 1), 24_576: (16, 0), 6_144: (16, 0),
                  393_216: (0, 1), 1_572_864: (0, 1)}
SYNC_BATCHES = 2  # the synchronous loop's (two distinct batches)
BUNDLE_REQUESTS = 3
# phase 13: a CompressAI-format file of mbt2018-mean q8 (N = 192, M = 320,
# the served codec of phase 3) finalized by `update_model_cli
# --from-torch` and served from the result; the training step of phase 5
# under --remat (12 `gdn_fwd` and 6 of each backward kernel a step: every
# GDN runs again in its block's recompute); the master under --remat at
# lmic_tpu's batch of 16 (18 and 6: the frozen guide's 6 run once)
PRETRAINED_ARCH, PRETRAINED_QUALITY = "mbt2018-mean", 8
PRETRAINED_REQUESTS = 3
REMAT_STEP = {"gdn_fwd": 12, "gdn_bwd_dx": 6, "gdn_bwd_partials": 6,
              "gdn_bwd_reduce": 6}
REMAT_MASTER_BATCH = 16
# f32/bf16 gdn_fwd rows of a --remat step: each GDN and IGDN of phase 5's
# step twice, in the forward and in its block's recompute
REMAT_ROWS = {r: 2 for r in TRAIN_ROWS[:3]}
# the bars of a remat step against the plain one on the card: the card's
# f32 and bf16 bars of the training phases
REMAT_BARS = {"f32": (1e-4, 1e-3), "amp": (1e-3, 2e-2)}


def log(*a):
    print(*a, flush=True)


def phase_environment():
    import torch

    from lmic_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {nvcc[-1]}")
    t0 = time.perf_counter()
    sources = ("gdn_fwd.cu", "gdn_bwd.cu", "lmic_rans.cc")
    with ThreadPoolExecutor(len(sources)) as pool:  # one compiler each
        libs = list(pool.map(_build.build, sources))
    log(f"built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    for source, lib in zip(sources, libs):
        if not source.endswith(".cu"):
            continue
        _check_registers(source, lib + ".log")
        _check_tensor_cores(source, lib)
    return smi


# The GDN kernels by name: the bf16 product kernels run on the tensor
# cores; the f32 kernels (TF32 off) and the reduce must not.
MMA_KERNELS = ("gdn_fwd_mma_kernel", "gdn_bwd_dx_mma_kernel",
               "gdn_bwd_partials_mma_kernel")
FP32_KERNELS = ("gdn_fwd_kernel", "gdn_bwd_dx_kernel",
                "gdn_bwd_partials_kernel", "gdn_bwd_reduce_kernel")


# The register-tiled f32 kernels (8 x 4 accumulators a thread): the two on
# the shared loop of csrc/gdn_f32.cuh and the partials. Their accumulators
# must stay in registers.
TILED_FP32_KERNELS = ("gdn_fwd_kernel", "gdn_bwd_dx_kernel",
                      "gdn_bwd_partials_kernel")


def _check_registers(source, log_path):
    """Log each kernel's registers and spills from the build's ptxas
    output (-Xptxas -v); raise if a register-tiled f32 kernel spills."""
    kernel, seen = None, {}
    with open(log_path) as f:
        for line in f:
            # the name with its template arguments (direction, width)
            m = re.search(r"(?:entry function '|Function properties for )"
                          r"\S*?(gdn_[a-z_]+?_kernel(?:I\w+?EE)?)", line)
            if m:
                kernel = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and kernel:
                seen.setdefault(kernel, {})["spill"] = (int(m.group(1)),
                                                        int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and kernel:
                seen.setdefault(kernel, {})["registers"] = int(m.group(1))
    for kernel, info in sorted(seen.items()):
        log(f"ptxas {source} {kernel}: {info.get('registers')} registers, "
            f"spill stores/loads {info.get('spill')} bytes")
        if kernel.startswith(TILED_FP32_KERNELS) and any(
                info.get("spill", (1, 1))):
            raise AssertionError(f"{kernel} spills: {info}")
    if not any(k.startswith(TILED_FP32_KERNELS) for k in seen):
        raise AssertionError(f"no ptxas report of the f32 kernels in "
                             f"{log_path}")


def _check_tensor_cores(source, lib):
    """Count HMMA instructions per kernel in `lib` (cuobjdump -sass); raise
    if a bf16 product kernel has none or another GDN kernel has one."""
    from lmic_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = {}  # kernel name -> HMMA count of each instantiation
    current = None
    for line in sass.splitlines():
        # letters and underscores only: the anonymous namespace's mangled
        # name (gdn_fwd_cu_<hash>) comes first on the line
        m = re.search(r"Function : \S*?(gdn_[a-z_]+?_kernel)", line)
        if m:
            current = counts.setdefault(m.group(1), [])
            current.append(0)
        elif current is not None and "HMMA" in line:
            current[-1] += 1
    log(f"HMMA instructions in {source}: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    for name, found in counts.items():
        if name in MMA_KERNELS and not all(found):
            raise AssertionError(f"{name} has no tensor-core instruction")
        if name not in MMA_KERNELS and any(found):
            raise AssertionError(f"{name} runs on the tensor cores")
    want = {k for k in MMA_KERNELS + FP32_KERNELS
            if k.startswith(source[:-3] + "_")}
    if set(counts) != want:
        raise AssertionError(f"{source}: kernels {sorted(counts)}, "
                             f"expected {sorted(want)}")


def _peaks(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def _time_ms(fn, runs=10, warmup=3):
    """Median device time of one call of `fn` over `runs` calls, after
    warm-up, from CUDA events. A ~1 ms spin kernel is queued before each
    timed call, so the call's host work (Python, checks, launch) overlaps
    it and the events time the device work alone, not the host's pace."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)  # cycles: ~1 ms at H100 clocks
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _gdn_inputs(gen, n, C, dt):
    import torch

    x = torch.randn((n, C), generator=gen, device="cuda").to(dt)
    beta = (torch.rand(C, generator=gen, device="cuda") + 0.5).to(dt)
    # upper-triangular, so a kernel that reads gamma^T for gamma disagrees
    gamma = ((torch.rand((C, C), generator=gen, device="cuda") * 4.0 / C
              + 0.1 * torch.eye(C, device="cuda")).triu()).to(dt)
    g = torch.randn((n, C), generator=gen, device="cuda").to(dt)
    return x, beta, gamma, g


def _errors(got, want):
    """(max |a-b|, max |a-b| / max(1, max |b|)) over the outputs."""
    abs_err = rel = 0.0
    for a, b in zip(got, want):
        e = (a.float() - b.float()).abs().max().item()
        abs_err = max(abs_err, e)
        rel = max(rel, e / max(1.0, b.float().abs().max().item()))
    return abs_err, rel


def _dx_composite(x, beta, gamma, gamma_t, g, inverse):
    """(dx, dn) in a few cuBLAS/elementwise calls, in the input dtype (bf16
    products on the tensor cores)."""
    import torch

    norm = torch.addmm(beta, x * x, gamma_t)
    r = torch.rsqrt(norm)
    if inverse:
        dn, scale = 0.5 * g * x * r, norm * r
    else:
        dn, scale = -0.5 * g * x * (r * r * r), r
    return torch.addcmul(g * scale, 2 * x, dn @ gamma), dn


def _bwd_composite(x, beta, gamma, gamma_t, g, inverse):
    """The backward's math in a few cuBLAS/elementwise calls: the
    yardstick."""
    dx, dn = _dx_composite(x, beta, gamma, gamma_t, g, inverse)
    return dx, dn.sum(0), dn.t() @ (x * x)


def _bwd_launches(x, beta, gamma, gamma_t, g, inverse):
    """The three launches of `gdn.gdn_bwd`, each on its own, through the
    same C ABI on buffers of their own: they compare and time each kernel
    and count no launch. Returns {name: call returning its outputs}."""
    import torch

    from lmic_tpu_torch.ops import gdn

    lib = gdn._load("gdn_bwd.cu")
    n, C = x.shape
    chunks = -(-n // lib.lmic_gdn_bwd_chunk_rows())
    dx = torch.empty_like(x)
    dn = torch.empty((n, C), dtype=torch.float32, device="cuda")
    partials = torch.empty((chunks, C * C + C), dtype=torch.float32,
                           device="cuda")
    dbeta = torch.empty(C, dtype=x.dtype, device="cuda")
    dgamma = torch.empty((C, C), dtype=x.dtype, device="cuda")
    code = gdn._DTYPE_CODES[x.dtype]
    stream = torch.cuda.current_stream().cuda_stream

    def check(err, what):
        if err:
            raise RuntimeError(f"{what}: "
                               f"{lib.lmic_gdn_bwd_error_string(err).decode()}")

    def run_dx():
        check(lib.lmic_gdn_bwd_dx(
            x.data_ptr(), g.data_ptr(), gamma_t.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), dx.data_ptr(), dn.data_ptr(), n, C, code,
            int(inverse), stream), "gdn_bwd_dx")
        return dx, dn

    def run_partials():
        check(lib.lmic_gdn_bwd_partials(x.data_ptr(), dn.data_ptr(),
                                        partials.data_ptr(), n, C, code,
                                        stream), "gdn_bwd_partials")
        return (partials,)

    def run_reduce():
        check(lib.lmic_gdn_bwd_reduce(partials.data_ptr(), dbeta.data_ptr(),
                                      dgamma.data_ptr(), chunks, C, code,
                                      stream), "gdn_bwd_reduce")
        return dbeta, dgamma

    return {"gdn_bwd_dx": run_dx, "gdn_bwd_partials": run_partials,
            "gdn_bwd_reduce": run_reduce}


def _dx_plain(x, beta, gamma, g, inverse):
    """gdn_bwd_dx's outputs (dx, the f32 dn) in plain torch, as
    gdn_bwd_reference forms them."""
    import torch

    x32, g32 = x.float(), g.float()
    norm = torch.matmul((x * x).float(), gamma.float().t()) + beta.float()
    if inverse:
        dn, scale = 0.5 * g32 * x32 * torch.rsqrt(norm), torch.sqrt(norm)
    else:
        dn, scale = -0.5 * g32 * x32 * norm ** -1.5, torch.rsqrt(norm)
    dnx = dn.to(x.dtype).float()
    dx = g32 * scale + 2.0 * x32 * torch.matmul(dnx, gamma.float())
    return dx.to(x.dtype), dn


def _partials_plain(x, dn, rows):
    """gdn_bwd_partials' output in plain torch: per chunk of `rows` rows,
    dn (rounded to x's type) transposed times x^2, then the sum of dn."""
    import torch

    n, C = x.shape
    chunks = -(-n // rows)
    pad = torch.zeros((chunks * rows - n, C), device=x.device)
    d = torch.cat([dn, pad]).view(chunks, rows, C)
    x2 = torch.cat([(x * x).float(), pad]).view(chunks, rows, C)
    dgamma = torch.bmm(d.to(x.dtype).float().transpose(1, 2), x2)
    return (torch.cat([dgamma.reshape(chunks, C * C), d.sum(1)], 1),)


def _partials_library(x, dn, rows):
    """One cuBLAS call of the partials' chunked product, dn^T . x^2 per
    chunk, on padded, squared operands built here (outside the timed call)
    in the kernel's operand type; TF32 is off. It leaves out x^2 and dbeta."""
    import torch

    n, C = x.shape
    chunks = -(-n // rows)
    pad = torch.zeros((chunks * rows - n, C), device=x.device, dtype=x.dtype)
    d = torch.cat([dn.to(x.dtype), pad]).view(chunks, rows, C)
    x2 = torch.cat([x * x, pad]).view(chunks, rows, C)
    return lambda: torch.bmm(d.transpose(1, 2), x2)


def _reduce_plain(partials, C, dt):
    """gdn_bwd_reduce's outputs in plain torch: the partials added in chunk
    order, one f32 add each, then cast once."""
    total = partials[0].clone()
    for k in range(1, partials.shape[0]):
        total += partials[k]
    return total[C * C:].to(dt), total[:C * C].view(C, C).to(dt)


def phase_kernel(peaks):
    """Both GDN kernels against their plain versions at every main-path
    shape (serving, training, the RGB-T pair's wire and its training
    step, the batched synthesis of phase 12); returns the per-shape cases
    of each."""
    import torch

    from lmic_tpu_torch.ops import gdn

    mem_bw, fp32, bf16 = peaks
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {k: [] for k in ("gdn_fwd", "gdn_bwd") + gdn.BWD_KERNELS}
    shapes = [(n, C) for C in (128, 192) for n in SERVE_ROWS + TRAIN_ROWS]
    # f32 only: the pair's wire, the master step's frozen guide and the
    # batched synthesis
    f32_only = RGBT_ROWS + MASTER_GUIDE_ROWS + PIPE_ROWS
    shapes += [(n, 192) for n in f32_only]
    # no backward: serving, the frozen guide, the batched synthesis
    fwd_only = tuple(n for n in SERVE_ROWS + f32_only
                     if n not in MASTER_TRAIN_ROWS)
    for n, C in shapes:
        for dtype in (("float32",) if n in f32_only
                      else ("float32", "bfloat16")):
            dt = getattr(torch, dtype)
            x, beta, gamma, g = _gdn_inputs(gen, n, C, dt)
            gamma_t = gamma.t().contiguous()
            es = x.element_size()
            peak = fp32 if es == 4 else bf16
            for inverse in (False, True):
                rs = torch.sqrt if inverse else torch.rsqrt
                work = {
                    "gdn_fwd": (
                        lambda: (gdn.gdn_fwd(x, beta, gamma, inverse),),
                        lambda: (gdn.gdn_reference(x, beta, gamma,
                                                   inverse),),
                        lambda: x * rs(torch.addmm(beta, x * x, gamma_t)),
                        # x read, y written, gamma and beta read
                        (2 * n * C + C * C + C) * es,
                        2 * n * C * C + 4 * n * C,
                    ),
                    "gdn_bwd": (
                        lambda: gdn.gdn_bwd(x, beta, gamma, g, inverse),
                        lambda: gdn.gdn_bwd_reference(x, beta, gamma, g,
                                                      inverse),
                        lambda: _bwd_composite(x, beta, gamma, gamma_t, g,
                                               inverse),
                        # x and g read, dx written; gamma, beta read;
                        # dgamma, dbeta written
                        (3 * n * C + 2 * (C * C + C)) * es,
                        6 * n * C * C + 12 * n * C,
                    ),
                }
                for name, (run, plain, composite, nbytes, ops) in \
                        work.items():
                    if name == "gdn_bwd" and n in fwd_only:
                        continue
                    if name == "gdn_bwd":
                        _bwd_kernel_cases(cases, x, beta, gamma, gamma_t, g,
                                          inverse, peak, mem_bw, fp32)
                    got = run()
                    want = plain()
                    torch.cuda.synchronize()
                    err, rel = _errors(got, want)
                    if not rel < TOL[dtype]:
                        raise AssertionError(
                            f"{name} {n}x{C} {dtype} inverse={inverse}: "
                            f"error {rel:.3g} >= {TOL[dtype]}")
                    if name == "gdn_fwd" and dtype == "float32" and err:
                        # the wire's kernel, which this check holds still
                        raise AssertionError(
                            f"f32 gdn_fwd {n}x{C} inverse={inverse} differs "
                            f"from its plain version by {err:.3g}")
                    if not all(torch.equal(a, b) for a, b in zip(got, run())):
                        raise AssertionError(f"{name} is not deterministic")
                    t_mem, t_ops = nbytes / mem_bw, ops / peak
                    cases[name].append({
                        "shape": [n, C], "dtype": dtype, "inverse": inverse,
                        "max_abs_err": err, "max_rel_err": rel,
                        "us": 1e3 * _time_ms(run),
                        "plain_us": 1e3 * _time_ms(plain),
                        "library_us": 1e3 * _time_ms(composite),
                        "bound_us": 1e6 * max(t_mem, t_ops),
                        "bound_by": ("operations" if t_ops > t_mem
                                     else "bytes"),
                        "bytes_us": 1e6 * t_mem, "operations_us": 1e6 * t_ops,
                    })
            del x, beta, gamma, g, gamma_t
    return cases


def _bwd_kernel_cases(cases, x, beta, gamma, gamma_t, g, inverse, peak,
                      mem_bw, fp32):
    """Each of gdn_bwd's three launches against its plain version on the
    same inputs (the kernel's own dn and partials feed the next two), timed
    on its own, with its own bound."""
    import torch

    from lmic_tpu_torch.ops import gdn

    n, C = x.shape
    es, dt = x.element_size(), x.dtype
    launch = _bwd_launches(x, beta, gamma, gamma_t, g, inverse)
    dn = launch["gdn_bwd_dx"]()[1]
    partials = launch["gdn_bwd_partials"]()[0]
    rows = gdn._load("gdn_bwd.cu").lmic_gdn_bwd_chunk_rows()
    chunks = partials.shape[0]
    ccc = C * C + C
    work = {  # plain, library call, bytes, operations, peak
        "gdn_bwd_dx": (
            lambda: _dx_plain(x, beta, gamma, g, inverse),
            lambda: _dx_composite(x, beta, gamma, gamma_t, g, inverse),
            # x, g read; dx, dn (f32) written; gamma, beta read
            3 * n * C * es + 4 * n * C + ccc * es,
            4 * n * C * C + 12 * n * C, peak),
        "gdn_bwd_partials": (
            lambda: _partials_plain(x, dn, rows),
            _partials_library(x, dn, rows),
            # x, dn read; the partials written
            n * C * es + 4 * n * C + 4 * chunks * ccc,
            2 * n * C * C + 2 * n * C, peak),
        "gdn_bwd_reduce": (
            lambda: _reduce_plain(partials, C, dt),
            lambda: partials.sum(0),
            4 * chunks * ccc + ccc * es, chunks * ccc, fp32),
    }
    for name, (plain, library, nbytes, ops, pk) in work.items():
        run = launch[name]
        got = run()
        want = plain()
        torch.cuda.synchronize()
        err, rel = _errors(got, want)
        if not rel < TOL[str(dt).split(".")[-1]]:
            raise AssertionError(f"{name} {n}x{C} {dt} inverse={inverse}: "
                                 f"error {rel:.3g}")
        if not all(torch.equal(a, b) for a, b in zip(
                [t.clone() for t in got], run())):
            raise AssertionError(f"{name} is not deterministic")
        t_mem, t_ops = nbytes / mem_bw, ops / pk
        cases[name].append({
            "shape": [n, C], "dtype": str(dt).split(".")[-1],
            "inverse": inverse, "max_abs_err": err, "max_rel_err": rel,
            "us": 1e3 * _time_ms(run),
            "plain_us": 1e3 * _time_ms(plain),
            "library_us": 1e3 * _time_ms(library),
            "bound_us": 1e6 * max(t_mem, t_ops),
            "bound_by": "operations" if t_ops > t_mem else "bytes",
            "bytes_us": 1e6 * t_mem, "operations_us": 1e6 * t_ops,
        })


def _reset_counts():
    from lmic_tpu_torch.ops import gdn

    for k in gdn.LAUNCHES:
        gdn.LAUNCHES[k] = 0


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", path, body=payload)
        resp = conn.getresponse()
        body = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise AssertionError(f"{path}: HTTP {resp.status}: {body[:300]!r}")
    return body


def _images(n, shape=IMAGE, seed=0):
    """Seeded test images: smooth gradients plus noise, uint8."""
    rng = np.random.default_rng(seed)
    _, H, W, C = shape
    yy, xx = np.mgrid[0:H, 0:W] / max(H, W)
    out = []
    for _ in range(n):
        base = sum(rng.uniform(-1, 1) * np.sin(rng.uniform(1, 12) * yy
                                               + rng.uniform(1, 12) * xx
                                               + rng.uniform(0, 6))
                   for _ in range(4))
        img = 128 + 40 * base[..., None] + rng.normal(0, 12, (H, W, C))
        out.append(np.clip(img, 0, 255).astype(np.uint8)[None])
    return out


def _roundtrip_checks(codec, x, strings, shape):
    """The decoder recovers exactly the encoder's latents: the float decode
    equals g_s of round(y - mu) + mu computed on the encode side."""
    import torch

    from lmic_tpu_torch.models.codec import _symbols_to_host

    with torch.inference_mode():
        xt = codec._pixels(x)
        if hasattr(codec.module, "analyze"):
            y, z = codec.module.analyze(xt)
            z_sym = _symbols_to_host(
                torch.round(z - codec._medians(codec.eb_state)))
            _, means = codec._params_for_wire_z(z_sym)
        else:
            y = codec.module.g_a(xt)
            means = codec._medians(codec.eb_state)
        y_hat = torch.round(y if means is None else y - means)
        want = codec._synthesize(
            y_hat if means is None else y_hat + means, u8=False
        )["x_hat"]
    got = codec.decompress(strings, shape)["x_hat"]
    if not np.isfinite(got).all() or got.shape != x.shape:
        raise AssertionError(f"bad decode: shape {got.shape}")
    if not np.array_equal(got, want):
        raise AssertionError("decode did not recover the encoded latents")


def _cpu_agreement(arch, codec, quality=QUALITY):
    """The CUDA transforms (GDN kernel, cuDNN without TF32) against the CPU
    plain-version transforms, same seed, on a small input: f32 sums in
    another order, so within 1e-4 of the largest value; for an AR codec
    also every wavefront step's scales and means on the same latents.
    Returns {"transforms": error} (and "step", "index_flips", "indexes")."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.models.joint import JointARCodec
    from lmic_tpu_torch.utils.crosscheck import wavefront_step_agreement

    cpu = zoo.create_model(arch, quality, seed=0, device="cpu")
    x = _images(1, (1, 64, 128, 3), seed=7)[0]
    with torch.inference_mode():
        xs = [c._pixels(x) for c in (codec, cpu)]
        outs = []
        for c, xt in zip((codec, cpu), xs):
            y = c.module.g_a(xt)
            outs.append([y, c.module.g_s(torch.round(y))])
            if hasattr(c.module, "h_a"):
                outs[-1].append(c.module.h_a(c.module._hyper_input(y)))
    worst = 0.0
    for a, b in zip(*outs):
        a, b = a.float().cpu(), b.float()
        worst = max(worst, ((a - b).abs().max() / b.abs().max()).item())
    if not worst < 1e-4:
        raise AssertionError(f"{arch}: CUDA vs CPU transforms {worst:.3g}")
    cpu.update()  # coding tables are built on the CPU on both
    for state in ("eb_state", "gc_state"):
        a, b = getattr(codec, state), getattr(cpu, state)
        if a is not None and not np.array_equal(a.table.cdf, b.table.cdf):
            raise AssertionError(f"{arch}: {state} tables differ")
    out = {"transforms": worst}
    if isinstance(codec, JointARCodec):
        err, flips, n = wavefront_step_agreement(codec, cpu, x)
        if not err < 1e-4:
            raise AssertionError(f"{arch}: CUDA vs CPU wavefront step "
                                 f"{err:.3g}")
        out.update(step=err, index_flips=flips, indexes=n)
    return out


def phase_serving():
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.codec_cli import read_body
    from lmic_tpu_torch.utils.serve import (
        _read_pixels,
        _write_pixels,
        make_server,
    )

    t0 = time.perf_counter()
    codec = zoo.create_model(SERVE_ARCH, QUALITY, seed=0, device="cuda")
    codec.update()
    log(f"{SERVE_ARCH} q{QUALITY} (N={codec.module.N}, M={codec.module.M}) "
        f"built and updated in {time.perf_counter() - t0:.1f} s")
    images = _images(3)
    codec.decompress(**codec.compress(images[0]), u8=True)  # warm-up
    server = make_server(codec, {"family": "image", "arch": SERVE_ARCH,
                                 "quality": QUALITY,
                                 "input_shape": list(IMAGE)})
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        bodies, recs, times, stats = [], [], [], []
        _reset_counts()
        for x in images:
            f = io.BytesIO()
            _write_pixels(f, x)
            t1 = time.perf_counter()
            body = _post(port, "/compress", f.getvalue())
            t2 = time.perf_counter()
            enc_stats = dict(codec.stats)
            rec = _post(port, "/decompress", body)
            t3 = time.perf_counter()
            bodies.append(body)
            recs.append(rec)
            times.append((1e3 * (t2 - t1), 1e3 * (t3 - t2)))
            stats.append({**enc_stats, **codec.stats})
        counts = dict(gdn.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = counts.pop("gdn_fwd")
    if launches != 6 * len(images):  # 3 GDN in g_a + 3 IGDN in g_s
        raise AssertionError(f"main path launched gdn_fwd {launches} times")
    if any(counts.values()):  # no autograd under inference_mode
        raise AssertionError(f"serving launched backward kernels: {counts}")
    for i, (x, body, rec, (tc, td), st) in enumerate(
            zip(images, bodies, recs, times, stats)):
        shape, groups = read_body(io.BytesIO(body))
        t1 = time.perf_counter()
        direct = codec.compress(x)
        t_direct = 1e3 * (time.perf_counter() - t1)
        if [list(g) for g in direct["strings"]] != groups \
                or tuple(direct["shape"]) != tuple(shape):
            raise AssertionError("encoding is not deterministic")
        want = codec.decompress(direct["strings"], direct["shape"], u8=True)
        got = _read_pixels(io.BytesIO(rec))
        if got.shape != x.shape or not np.array_equal(got, want["x_hat"]):
            raise AssertionError("/decompress differs from the codec")
        if i == 0:
            _roundtrip_checks(codec, x, direct["strings"], direct["shape"])
        nbytes = sum(len(s) for g in groups for s in g)
        mse = np.mean((got.astype(np.float64) - x) ** 2)
        log(f"serve image {i}: {nbytes} bytes, "
            f"{8 * nbytes / (x.shape[1] * x.shape[2]):.4f} bpp, "
            f"PSNR {10 * np.log10(255 ** 2 / mse):.2f} dB (random weights), "
            f"/compress {tc:.1f} ms (direct call {t_direct:.1f} ms), "
            f"/decompress {td:.1f} ms; stages ms "
            + json.dumps({k: round(v, 2) for k, v in st.items()}))
    worst = _cpu_agreement(SERVE_ARCH, codec)["transforms"]
    log(f"{SERVE_ARCH}: CUDA vs CPU transforms within {worst:.3g}")
    return launches


def phase_other_archs():
    from lmic_tpu_torch import zoo

    x = _images(1, seed=3)[0]
    for arch in ("bmshj2018-factorized", "bmshj2018-hyperprior"):
        codec = zoo.create_model(arch, QUALITY, seed=0, device="cuda")
        codec.update()
        codec.compress(x)  # warm-up
        t0 = time.perf_counter()
        out = codec.compress(x)
        t1 = time.perf_counter()
        rec = codec.decompress(out["strings"], out["shape"], u8=True)
        t2 = time.perf_counter()
        if codec.compress(x)["strings"] != out["strings"]:
            raise AssertionError(f"{arch}: encoding is not deterministic")
        if rec["x_hat"].shape != x.shape or rec["x_hat"].dtype != np.uint8:
            raise AssertionError(f"{arch}: bad decode {rec['x_hat'].shape}")
        _roundtrip_checks(codec, x, out["strings"], out["shape"])
        worst = _cpu_agreement(arch, codec)["transforms"]
        nbytes = sum(len(s) for g in out["strings"] for s in g)
        log(f"{arch} q{QUALITY}: {nbytes} bytes, compress "
            f"{1e3 * (t1 - t0):.1f} ms, decompress {1e3 * (t2 - t1):.1f} ms, "
            f"CUDA vs CPU transforms within {worst:.3g}")


def _ar_roundtrip_checks(codec, x, strings):
    """Encoding is deterministic and the AR decoder recovers exactly the
    encoder's latents (the wavefront loops agree bit for bit)."""
    import torch

    with torch.inference_mode():
        ys, z_sym = codec._analyze(x)
        enc = codec._code_y_z(ys, z_sym, keep_y_hat=True)
        dec = codec._decode_y_hat(enc["strings"], enc["shape"])
    if enc["strings"] != strings:
        raise AssertionError("AR encoding is not deterministic")
    if not torch.equal(dec, enc["y_hat_latent"]):
        raise AssertionError("AR decode did not recover the encoded latents")


def _ar_stages(stats, T):
    """codec.stats of one round trip, with the decode loop per wavefront."""
    out = {k: round(v, 3) for k, v in stats.items()}
    for k in ("dec_loop_ms", "dec_loop_device_ms", "dec_loop_rans_ms"):
        out[k.replace("_ms", "_per_wavefront_us")] = round(
            1e3 * stats[k] / T, 1)
    return out


def _ar_round_trip(codec, x):
    """One timed direct round trip: (out, rec, compress ms, decompress ms,
    stats of both)."""
    t0 = time.perf_counter()
    out = codec.compress(x)
    t1 = time.perf_counter()
    stats = dict(codec.stats)
    rec = codec.decompress(out["strings"], out["shape"], u8=True)
    t2 = time.perf_counter()
    return out, rec, 1e3 * (t1 - t0), 1e3 * (t2 - t1), {**stats,
                                                         **codec.stats}


def _log_ar_profile(arch, codec, x):
    """Where one AR round trip's time goes on the card: for compress and
    for decompress, the device time of one call (torch.profiler) against
    the wall time of one call without the profiler (its busy share), the
    device operations, and the largest kernels."""
    out = codec.compress(x)
    for what, run in (("compress", lambda: codec.compress(x)),
                      ("decompress", lambda: codec.decompress(
                          out["strings"], out["shape"], u8=True))):
        t0 = time.perf_counter()
        run()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        gdn_ms, dev_ms, _, top, ops = _profile(run, n=1)
        log(f"AR profile {arch} {what}: device {dev_ms:.2f} ms of wall "
            f"{wall_ms:.2f} ms (busy {100 * dev_ms / wall_ms:.1f} %), "
            f"{ops:.0f} device operations, GDN {gdn_ms:.3f} ms; device ms "
            "of the largest kernels: "
            + json.dumps({k: round(v, 3) for k, v in top.items()}))


def _log_conv_route():
    """Why the codecs' stride-1 convs skip cuDNN on the card (layers.py
    `Conv`): cheng2020's 192 -> 192 3x3 conv at 128x192 (N = 192, a
    512x768 image) through cuDNN and through the im2col + GEMM route,
    device time and device operations of each."""
    import torch
    import torch.nn.functional as F

    from lmic_tpu_torch.layers.layers import _conv_gemm

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, 192, 128, 192), generator=gen, device="cuda")
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn((192, 192, 3, 3), generator=gen, device="cuda") / 40
    b = torch.zeros(192, device="cuda")
    runs = {"cudnn": lambda: F.conv2d(x, w, b, padding=1),
            "gemm_route": lambda: _conv_gemm(x, w, b, (1, 1))}
    out = {}
    with torch.inference_mode():
        err, _ = _errors([runs["gemm_route"]()], [runs["cudnn"]()])
        for name, run in runs.items():
            ops = _profile(run, n=1)[4]
            out[name] = {"ms": round(_time_ms(run, runs=3, warmup=1), 3),
                         "device_operations": ops}
    log("conv3x3 192->192 at 128x192, f32, TF32 off: " + json.dumps(out)
        + f", max |route - cudnn| {err:.3g}")


def _check_launches(what, counts, n):
    """n round trips: 6 gdn_fwd launches each (3 GDN in g_a, 3 IGDN in
    g_s) and no backward kernel."""
    rest = {k: v for k, v in counts.items() if k != "gdn_fwd"}
    if counts["gdn_fwd"] != 6 * n or any(rest.values()):
        raise AssertionError(f"{what}: launches {counts} in {n} round trips")


def phase_ar_serving():
    """The AR family's serving path; returns (gdn_fwd launches, seconds)."""
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.models.joint import _wavefront_positions
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.codec_cli import read_body
    from lmic_tpu_torch.utils.serve import (
        _read_pixels,
        _write_pixels,
        make_server,
    )

    t_phase = time.perf_counter()
    T = _wavefront_positions(IMAGE[1] // 16, IMAGE[2] // 16)
    codec = zoo.create_model(AR_SERVE_ARCH, AR_QUALITY, seed=0,
                             device="cuda")
    codec.update()
    log(f"{AR_SERVE_ARCH} q{AR_QUALITY} (N={codec.module.N}, "
        f"M={codec.module.M}): {T} wavefronts an image of "
        f"{IMAGE[1]}x{IMAGE[2]}")
    images = _images(3, seed=21)
    codec.decompress(**codec.compress(images[0]), u8=True)  # warm-up
    server = make_server(codec, {"family": "image", "arch": AR_SERVE_ARCH,
                                 "quality": AR_QUALITY,
                                 "input_shape": list(IMAGE)})
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        runs = []
        _reset_counts()
        for x in images:
            f = io.BytesIO()
            _write_pixels(f, x)
            t1 = time.perf_counter()
            body = _post(port, "/compress", f.getvalue())
            t2 = time.perf_counter()
            enc_stats = dict(codec.stats)
            rec = _post(port, "/decompress", body)
            t3 = time.perf_counter()
            runs.append((body, rec, 1e3 * (t2 - t1), 1e3 * (t3 - t2),
                         {**enc_stats, **codec.stats}))
        counts = dict(gdn.LAUNCHES)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = counts["gdn_fwd"]
    _check_launches(f"{AR_SERVE_ARCH} served", counts, len(images))
    for i, (x, (body, rec, tc, td, st)) in enumerate(zip(images, runs)):
        shape, groups = read_body(io.BytesIO(body))
        direct = codec.compress(x)
        if [list(g) for g in direct["strings"]] != groups \
                or tuple(direct["shape"]) != tuple(shape):
            raise AssertionError(f"{AR_SERVE_ARCH}: /compress differs from "
                                 "the codec")
        want = codec.decompress(direct["strings"], direct["shape"], u8=True)
        got = _read_pixels(io.BytesIO(rec))
        if got.shape != x.shape or not np.array_equal(got, want["x_hat"]):
            raise AssertionError(f"{AR_SERVE_ARCH}: /decompress differs "
                                 "from the codec")
        _ar_roundtrip_checks(codec, x, direct["strings"])
        nbytes = sum(len(s) for g in groups for s in g)
        log(f"AR serve {AR_SERVE_ARCH} image {i}: {nbytes} bytes, "
            f"{8 * nbytes / (x.shape[1] * x.shape[2]):.4f} bpp, /compress "
            f"{tc:.1f} ms, /decompress {td:.1f} ms; stages "
            + json.dumps(_ar_stages(st, T)))
    agree = _cpu_agreement(AR_SERVE_ARCH, codec, AR_QUALITY)
    log(f"{AR_SERVE_ARCH}: CUDA vs CPU " + json.dumps(agree))
    _log_ar_profile(AR_SERVE_ARCH, codec, images[0])
    del codec
    for arch, q in AR_DIRECT:
        codec = zoo.create_model(arch, q, seed=0, device="cuda")
        codec.update()
        x = _images(1, seed=22)[0]
        codec.compress(x)  # warm-up
        _reset_counts()
        out, rec, tc, td, st = _ar_round_trip(codec, x)
        counts = dict(gdn.LAUNCHES)
        launches += counts["gdn_fwd"]
        _check_launches(arch, counts, 1)
        if rec["x_hat"].shape != x.shape or rec["x_hat"].dtype != np.uint8:
            raise AssertionError(f"{arch}: bad decode {rec['x_hat'].shape}")
        _ar_roundtrip_checks(codec, x, out["strings"])
        agree = _cpu_agreement(arch, codec, q)
        nbytes = sum(len(s) for g in out["strings"] for s in g)
        log(f"AR {arch} q{q} (N={codec.module.N}): {nbytes} bytes, compress "
            f"{tc:.1f} ms, decompress {td:.1f} ms; stages "
            + json.dumps(_ar_stages(st, T)) + "; CUDA vs CPU "
            + json.dumps(agree))
        _log_ar_profile(arch, codec, x)
        del codec
    _log_conv_route()
    seconds = time.perf_counter() - t_phase
    log(f"AR serving phase: {seconds:.1f} s")
    return launches, seconds


def _rgbt_checks(guided, master, x, guide, body_strings=None):
    """One pair, direct calls: the guide's one-pass reconstruct equals its
    decompress bit for bit (x_hat and the gs* maps); encoding is
    deterministic (and equals `body_strings`, a server's, when given); the
    master's decoder recovers exactly the encoder's latents, and its
    alignment from the transmitted beta/gamma is the encoder's. Returns
    (the master's compress output, the guide's decoded output)."""
    import torch

    from lmic_tpu_torch.models.codec import _symbols_to_host

    g_out = guided.compress(guide, hidden=False, reconstruct=True)
    g_dec = guided.decompress(g_out["strings"], g_out["shape"])
    if not torch.equal(g_out["x_hat"], g_dec["x_hat"]) or not all(
            torch.equal(g_out["hidden_dec"][k], v)
            for k, v in g_dec["hidden"].items()):
        raise AssertionError("the guide's reconstruct differs from its "
                             "decompress")
    out = master.compress(x, g_out["x_hat"])
    if body_strings is not None and out["strings"] != body_strings:
        raise AssertionError("RGB-T /compress differs from the codec")
    with torch.inference_mode():
        g = g_out["x_hat"]
        feat, align, beta, gamma = master.module.features(
            master._pixels(x), g)
        y, z = master.module.analyze_features(feat, align)
        z_sym = _symbols_to_host(
            torch.round(z - master._medians(master.eb_state)))
        enc = master._code_y_z([y], z_sym, keep_y_hat=True)
        dec = master._decode_y_hat(enc["strings"], enc["shape"])
        align_dec = master.module.guided_align_from(g, beta, gamma)
    if enc["strings"] != out["strings"]:
        raise AssertionError("RGB-T master encoding is not deterministic")
    if not torch.equal(dec, enc["y_hat_latent"]):
        raise AssertionError("the master's decode did not recover the "
                             "encoded latents")
    if not torch.equal(align_dec, align):
        raise AssertionError("the master's decoder alignment differs")
    return out, g_dec


def _rgbt_cpu_agreement(guided, master, channel):
    """The pair's CUDA transforms against the CPU's, same seed, on a small
    input (the smallest master of each role), stage by stage on the same
    inputs (`utils/crosscheck.py::rgbt_agreement`): within 1e-4 of the
    largest value (f32 sums in another order), and equal coding tables."""
    from lmic_tpu_torch.utils.crosscheck import rgbt_agreement
    from lmic_tpu_torch.utils.serve import load_rgbt_codecs

    cpu, _ = load_rgbt_codecs(RGBT_QUALITY, channel, seed=0, device="cpu")
    factor = master.module.downsampling_factor
    gH, gW = master.expected_guide_hw(factor, factor)
    worst = rgbt_agreement(
        (guided, master), cpu,
        _images(1, (1, factor, factor, channel), seed=41)[0],
        _images(1, (1, gH, gW, 4 - channel), seed=42)[0])
    if not worst < 1e-4:
        raise AssertionError(f"RGB-T channel {channel}: CUDA vs CPU "
                             f"transforms {worst:.3g}")
    for cuda, ref in zip((guided, master), cpu):
        for state in ("eb_state", "gc_state"):
            if not np.array_equal(getattr(cuda, state).table.cdf,
                                  getattr(ref, state).table.cdf):
                raise AssertionError(f"RGB-T {state} tables differ")
    return worst


def _leg_stats(codec, prefix):
    """The stages of a codec's last compress ("enc_") or decompress
    ("dec_"), ms."""
    return {k: round(v, 2) for k, v in codec.stats.items()
            if k.startswith(prefix)}


def _log_rgbt_profile(what, run):
    """One leg's device time (torch.profiler) against its wall time without
    the profiler, its device operations, GDN time and largest kernels."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    gdn_ms, dev_ms, _, top, ops = _profile(run, n=1)
    log(f"RGB-T profile {what}: device {dev_ms:.2f} ms of wall "
        f"{wall_ms:.2f} ms (busy {100 * dev_ms / wall_ms:.1f} %), "
        f"{ops:.0f} device operations, GDN {gdn_ms:.3f} ms; device ms of "
        "the largest kernels: "
        + json.dumps({k: round(v, 3) for k, v in top.items()}))
    return gdn_ms


def phase_rgbt_serving():
    """The RGB-T pair's serving path; returns the gdn_fwd launches of the
    served requests and of the channel-3 round trip."""
    import torch

    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.codec_cli import read_body, read_floats
    from lmic_tpu_torch.utils.serve import (
        _read_pixels,
        _write_pixels,
        load_rgbt_codecs,
        make_server,
    )

    t_phase = time.perf_counter()
    (guided, master), meta = load_rgbt_codecs(RGBT_QUALITY, 1, seed=0,
                                              device="cuda")
    log(f"RGB-T q{RGBT_QUALITY} (N={master.module.N}, M={master.module.M}), "
        f"channel 1: master {RGBT_MASTER[1]}x{RGBT_MASTER[2]}, guide "
        f"{RGBT_GUIDE[1]}x{RGBT_GUIDE[2]}; built and updated in "
        f"{time.perf_counter() - t_phase:.1f} s")
    masters = _images(3, RGBT_MASTER, seed=31)
    guides = _images(3, RGBT_GUIDE, seed=32)
    # warm-up: a whole round trip
    master.decompress(*_rgbt_checks(guided, master, masters[0], guides[0]))
    server = make_server((guided, master), meta)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        runs, legs = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        for x, guide in zip(masters, guides):
            fx, fg = io.BytesIO(), io.BytesIO()
            _write_pixels(fx, x)
            _write_pixels(fg, guide)
            before = gdn.LAUNCHES["gdn_fwd"]
            t1 = time.perf_counter()
            body = _post(port, "/compress", fx.getvalue() + fg.getvalue())
            t2 = time.perf_counter()
            mid = gdn.LAUNCHES["gdn_fwd"]
            stats = {"guide": _leg_stats(guided, "enc_"),
                     "master": _leg_stats(master, "enc_")}
            rec = _post(port, "/decompress", body + fg.getvalue())
            t3 = time.perf_counter()
            legs.append((mid - before, gdn.LAUNCHES["gdn_fwd"] - mid))
            stats["master"].update(_leg_stats(master, "dec_"))
            runs.append((body, rec, 1e3 * (t2 - t1), 1e3 * (t3 - t2), stats))
        counts = dict(gdn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    launches = counts.pop("gdn_fwd")
    if launches != 12 * len(masters) or any(counts.values()) \
            or set(legs) != {(9, 3)}:
        raise AssertionError(f"RGB-T served: gdn_fwd {launches} in "
                             f"{len(masters)} round trips, per leg {legs}, "
                             f"others {counts}")
    for i, (x, guide, (body, rec, tc, td, st)) in enumerate(
            zip(masters, guides, runs)):
        f = io.BytesIO(body)
        shape, groups = read_body(f)
        beta, gamma = (np.asarray(read_floats(f, 64), np.float32)
                       for _ in range(2))
        out, g_dec = _rgbt_checks(guided, master, x, guide, groups)
        if tuple(out["shape"]) != tuple(shape) or not (
                np.array_equal(out["beta"].reshape(-1), beta)
                and np.array_equal(out["gamma"].reshape(-1), gamma)):
            raise AssertionError("RGB-T /compress side info differs")
        want = master.decompress(out, g_dec, u8=True)["x_hat"]
        got = _read_pixels(io.BytesIO(rec))
        if got.shape != x.shape or not np.array_equal(got, want):
            raise AssertionError("RGB-T /decompress differs from the codec")
        nbytes = sum(len(s) for g in groups for s in g)
        log(f"RGB-T serve pair {i}: master {nbytes} bytes + 512 of "
            f"beta/gamma, {8 * nbytes / (x.shape[1] * x.shape[2]):.4f} bpp; "
            f"/compress {tc:.1f} ms, /decompress {td:.1f} ms (guide "
            f"cached); stages ms " + json.dumps(st))
    log(f"RGB-T served: peak device memory {peak / 2**30:.2f} GiB over "
        f"{len(masters)} round trips")
    worst = _rgbt_cpu_agreement(guided, master, 1)
    log(f"RGB-T channel 1: CUDA vs CPU transforms within {worst:.3g}")
    x, guide = masters[0], guides[0]
    g_out = guided.compress(guide, hidden=False, reconstruct=True)
    out = master.compress(x, g_out["x_hat"])
    g_dec = {"x_hat": g_out["x_hat"], "hidden": g_out["hidden_dec"]}
    gdn_ms = _log_rgbt_profile("channel 1 /compress work", lambda: (
        master.compress(x, guided.compress(
            guide, hidden=False, reconstruct=True)["x_hat"])))
    gdn_ms += _log_rgbt_profile(
        "channel 1 /decompress work (guide cached)",
        lambda: master.decompress(out, g_dec, u8=True))
    log(f"RGB-T channel 1: GDN kernels {gdn_ms:.3f} ms a round trip "
        "(profiler)")
    del guided, master, g_out, g_dec, out

    # channel 3: an RGB master at 1024x1280, a thermal guide at 512x640
    (guided, master), _ = load_rgbt_codecs(RGBT_QUALITY, 3, seed=0,
                                           device="cuda")
    x = _images(1, RGBT_GUIDE, seed=33)[0]
    guide = _images(1, RGBT_MASTER, seed=34)[0]
    master.decompress(*_rgbt_checks(guided, master, x, guide))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    g_out = guided.compress(guide, hidden=False, reconstruct=True)
    out = master.compress(x, g_out["x_hat"])
    t1 = time.perf_counter()
    rec = master.decompress(
        out, {"x_hat": g_out["x_hat"], "hidden": g_out["hidden_dec"]},
        u8=True)["x_hat"]
    t2 = time.perf_counter()
    counts = dict(gdn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the guide's g_a and reconstruct, the master's g_a and g_s
    if counts.pop("gdn_fwd") != 12 or any(counts.values()):
        raise AssertionError(f"RGB-T channel 3: launches {gdn.LAUNCHES}")
    if rec.shape != x.shape or rec.dtype != np.uint8:
        raise AssertionError(f"RGB-T channel 3: bad decode {rec.shape}")
    _rgbt_checks(guided, master, x, guide, out["strings"])
    worst = _rgbt_cpu_agreement(guided, master, 3)
    nbytes = sum(len(s) for g in out["strings"] for s in g)
    log(f"RGB-T channel 3 (master {x.shape[1]}x{x.shape[2]}, guide "
        f"{guide.shape[1]}x{guide.shape[2]}): master {nbytes} bytes; "
        f"compress {1e3 * (t1 - t0):.1f} ms, decompress "
        f"{1e3 * (t2 - t1):.1f} ms; peak device memory "
        f"{peak / 2**30:.2f} GiB; CUDA vs CPU transforms within "
        f"{worst:.3g}")
    launches += 12
    log(f"RGB-T serving phase: {time.perf_counter() - t_phase:.1f} s")
    return launches


def _train_batch(shape, seed):
    """Seeded images as a (B, C, H, W) float32 batch in [0, 1] on the card,
    channels_last."""
    import torch

    x = np.concatenate(_images(shape[0], (1, *shape[1:]), seed=seed))
    return torch.from_numpy(x.astype(np.float32) / 255.0).permute(
        0, 3, 1, 2).cuda()


def _steps(step, state, batch, gen, n):
    """n train steps, each timed on the host clock between two
    synchronizes; returns (ms per step, metrics per step)."""
    import torch

    ms, metrics = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: float(v) for k, v in m.items()})
    return ms, metrics


GDN_KERNELS = MMA_KERNELS + FP32_KERNELS


def _profile(run, n=3, keep=12):
    """Device time per call of `run` of the GDN kernels and of all
    kernels, the wall time per call, the device ms per call of each GDN
    kernel and of the other kernels that take the most (`keep` of them;
    None: all), and the device operations per call, from a
    torch.profiler trace of n calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    gdn_us = total_us = 0.0
    by_kernel, ops = {}, 0
    for evt in prof.key_averages():
        # a record_function range seen on the device (Adam's step) spans
        # kernels that are counted on their own
        if evt.device_type != DeviceType.CUDA or evt.is_user_annotation:
            continue
        us = evt.self_device_time_total
        total_us += us
        ops += evt.count
        name = next((k for k in GDN_KERNELS if k in evt.key), None)
        if name:
            gdn_us += us
        name = name or evt.key[:60]
        by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / n
    if total_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:keep])
    return gdn_us / 1e3 / n, total_us / 1e3 / n, wall, top, ops / n


def _train_cpu_agreement():
    """One step of a narrow mbt2018-mean (N=32, M=48) on the card and on
    the CPU, same weights and noise: losses within 1e-4, and every clipped
    gradient leaf within 1e-3 of its largest value (f32 sums in another
    order on each device)."""
    from lmic_tpu_torch.utils.crosscheck import train_step_agreement

    x = _train_batch((2, 64, 128, 3), seed=11).cpu()
    loss_err, grad_err, _ = train_step_agreement(
        TRAIN_ARCH, TRAIN_QUALITY, x, TRAIN_LAMBDA, N=32, M=48)
    if not (loss_err < 1e-4 and grad_err < 1e-3):
        raise AssertionError(f"training step on the card vs the CPU: loss "
                             f"{loss_err:.3g}, gradients {grad_err:.3g}")
    return loss_err, grad_err


def _finalize(state, tmp):
    """save -> load -> update_model_file -> load_updated_model -> one
    compress/decompress of a 512x768 image that decodes to the encoded
    latents, with the strings of the trained codec."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils import checkpoint as ckpt
    from lmic_tpu_torch.utils.train import create_train_state, make_optimizer

    def fresh(seed):
        return zoo.create_model(TRAIN_ARCH, TRAIN_QUALITY, seed=seed,
                                device="cuda")

    path = os.path.join(tmp, "train.ckpt")
    ckpt.save_checkpoint(path, state, {"epoch": 0, "arch": TRAIN_ARCH,
                                       "quality": TRAIN_QUALITY},
                         is_best=True)
    other = create_train_state(fresh(1).module, make_optimizer())
    other, extra = ckpt.load_checkpoint(path, other)
    want = state.module.state_dict()
    if other.step != state.step or extra["arch"] != TRAIN_ARCH or not all(
            torch.equal(v, want[k])
            for k, v in other.module.state_dict().items()):
        raise AssertionError("checkpoint did not restore the train state")
    trained = fresh(2)
    ckpt.load_train_params(path, trained.module)
    out_path = ckpt.update_model_file(tmp, trained,
                                      f"{TRAIN_ARCH}-q{TRAIN_QUALITY}")
    deployed = ckpt.load_updated_model(out_path, fresh(3))
    x = _images(1, seed=5)[0]
    out = deployed.compress(x)
    if out["strings"] != trained.compress(x)["strings"]:
        raise AssertionError("the finalized codec codes other strings")
    _roundtrip_checks(deployed, x, out["strings"], out["shape"])
    got = deployed.decompress(out["strings"], out["shape"], u8=True)["x_hat"]
    nbytes = sum(len(s) for g in out["strings"] for s in g)
    mse = np.mean((got.astype(np.float64) - x) ** 2)
    return (os.path.basename(out_path),
            8 * nbytes / (x.shape[1] * x.shape[2]),
            10 * np.log10(255 ** 2 / mse))


def phase_training():
    """The training main path: mbt2018-mean q7, batch 16 of 256x256, f32
    and bf16 AMP. Returns the launch counts of the timed steps and the
    number of those steps."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    batch = _train_batch(TRAIN_BATCH, seed=1)
    counts = {k: 0 for k in gdn.LAUNCHES}
    steps = 0
    trained = None
    for mode, dtype, timed in (("f32", None, 8), ("amp", torch.bfloat16, 5)):
        t0 = time.perf_counter()
        module = zoo.create_model(TRAIN_ARCH, TRAIN_QUALITY, seed=0,
                                  device="cuda", dtype=dtype).module
        opt = make_optimizer()
        state = create_train_state(module, opt)
        step = make_train_step(module, opt, TRAIN_LAMBDA)
        gen = torch.Generator(device="cuda").manual_seed(0)
        _, warm = _steps(step, state, batch, gen, 2)
        t_warm = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        ms, mets = _steps(step, state, batch, gen, timed)
        launched = dict(gdn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for k, v in launched.items():
            if v != 6 * timed:  # 3 GDN in g_a, 3 IGDN in g_s per step
                raise AssertionError(
                    f"{mode}: {k} launched {v} times in {timed} steps")
            counts[k] += v
        steps += timed
        losses = [m["loss"] for m in warm + mets]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{mode}: loss not finite: {losses}")
        if mode == "f32":
            _, last = _steps(step, state, batch, gen, 1)
            losses.append(last[0]["loss"])
        # f32: 11 losses, after 10 steps; AMP: 7 losses, after 6 steps
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{mode}: loss did not fall: {losses}")
        log(f"{mode} loss over {len(losses)} steps on one batch: "
            + ", ".join(f"{v:.2f}" for v in losses))
        gdn_ms, dev_ms, wall_ms, top, _ = _profile(
            lambda: step(state, batch, gen))
        last = mets[-1]
        log(f"train {TRAIN_ARCH} q{TRAIN_QUALITY} {mode} batch "
            f"{TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}x{TRAIN_BATCH[2]}: step ms "
            f"{json.dumps([round(v, 2) for v in ms])} (median "
            f"{np.median(ms):.2f}); loss {last['loss']:.3f} mse "
            f"{last['mse_loss']:.6f} bpp {last['bpp_loss']:.4f} aux "
            f"{last['aux_loss']:.1f}; peak memory {peak / 2**30:.2f} GiB; "
            f"built + 2 warm-up steps {t_warm:.1f} s")
        log(f"train {mode} profile ({3} steps): GDN kernels {gdn_ms:.2f} ms "
            f"of {dev_ms:.2f} ms device time per step "
            f"({100 * gdn_ms / dev_ms:.1f} %), wall {wall_ms:.2f} ms per "
            f"step under the profiler (device busy "
            f"{100 * dev_ms / wall_ms:.1f} %); device ms per step of the "
            "largest kernels: "
            + json.dumps({k: round(v, 3) for k, v in top.items()}))
        if mode == "f32":
            trained = state
        else:
            del module, state, opt
    loss_err, grad_err = _train_cpu_agreement()
    log(f"training step on the card vs the CPU (N=32, M=48, same noise): "
        f"losses within {loss_err:.3g}, gradients within {grad_err:.3g}")
    with tempfile.TemporaryDirectory() as tmp:
        name, bpp, psnr = _finalize(trained, tmp)
    log(f"trained {TRAIN_ARCH} q{TRAIN_QUALITY} saved, reloaded, finalized "
        f"as {name}, round trip of a 512x768 image: {bpp:.4f} bpp, PSNR "
        f"{psnr:.2f} dB")
    return counts, steps


def _fft_kernels(kernels):
    return sorted(k for k in kernels if "fft" in k.lower())


def _log_train_convs():
    """The training shapes at risk of cuDNN's FFT engine (on an NVIDIA
    H100, without autograd, it took 166-204 ms for one 192 -> 192 3x3
    conv at 128x192, TF32 off; see `_log_conv_route`): a 3x3 conv forward
    and backward under autograd, as the training step runs it (cuDNN's
    heuristic pick, deterministic, TF32 off), at cheng2020's 192 -> 192 at
    128x128 (q6, batch 16 of 256x256) and the channel aligner's 256 -> 256
    at 512x640 (the master step, batch 4): device ms, device operations
    and FFT kernels. Returns {shape: (ms, operations, FFT kernels)}."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for B, C, H, W in ((16, 192, 128, 128), (4, 256, 512, 640)):
        x = torch.randn((B, C, H, W), generator=gen, device="cuda")
        x = x.contiguous(memory_format=torch.channels_last).requires_grad_()
        w = (torch.randn((C, C, 3, 3), generator=gen, device="cuda")
             / (3 * C ** 0.5)).requires_grad_()
        b = torch.zeros(C, device="cuda", requires_grad=True)
        g = torch.randn((B, C, H, W), generator=gen, device="cuda")

        def run():
            torch.autograd.backward(F.conv2d(x, w, b, padding=1), g)

        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            ms = _time_ms(run, runs=3, warmup=1)
            _, _, _, kernels, ops = _profile(run, n=1, keep=None)
        key = f"{B}x{C}x{H}x{W}"
        out[key] = (ms, ops, _fft_kernels(kernels))
        log(f"train conv3x3 {C}->{C} at {H}x{W}, batch {B}, forward + "
            f"backward, f32, TF32 off, cuDNN's pick: {ms:.2f} ms, {ops} "
            f"device operations, {len(out[key][2])} FFT kernels")
        del x, w, b, g
    return out


def _train_case(what, step, state, batches, gen, timed, per_step):
    """A warm-up step, a second one under the profiler, then `timed`
    steps with the launch counts set to 0 just before and read just
    after, which must be `per_step` of each kernel a step; the loss must
    stay finite and fall on the one batch. Logs the step ms, peak memory
    and the profiled step. Returns the launch counts of the timed
    steps."""
    import torch

    from lmic_tpu_torch.ops import gdn

    t0 = time.perf_counter()
    metrics = []

    def one():
        _, m = step(state, *batches, gen)
        metrics.append({k: float(v) for k, v in m.items()})

    one()
    gdn_ms, dev_ms, wall_ms, top, ops = _profile(one, n=1, keep=None)
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    ms = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
    launched = dict(gdn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = {k: per_step[k] * timed for k in launched}
    if launched != want:
        raise AssertionError(f"{what}: launches {launched} in {timed} "
                             f"steps, expected {want}")
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{what}: loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: loss did not fall: {losses}")
    last = metrics[-1]
    log(f"train {what}: step ms {json.dumps([round(v, 2) for v in ms])} "
        f"(median {np.median(ms):.2f}); loss over {len(losses)} steps "
        + ", ".join(f"{v:.2f}" for v in losses)
        + f"; mse {last['mse_loss']:.6f} bpp {last['bpp_loss']:.4f} aux "
        f"{last['aux_loss']:.1f}; peak memory {peak / 2**30:.2f} GiB; "
        f"built, a warm-up and a profiled step {t_warm:.1f} s, the case "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"train {what} profile (the second step): GDN kernels {gdn_ms:.2f} "
        f"ms of {dev_ms:.2f} ms device time ({100 * gdn_ms / dev_ms:.1f} %), "
        f"wall {wall_ms:.2f} ms under the profiler (device busy "
        f"{100 * dev_ms / wall_ms:.1f} %), {ops:.0f} device operations, FFT "
        f"kernels {len(_fft_kernels(top))}; device ms of the largest "
        "kernels: " + json.dumps({k: round(v, 3) for k, v in
                                  list(top.items())[:10]}))
    return launched


def _train_agreement_ar_rgbt():
    """One narrow step of cheng2020-attn (N = 32) and of the channel-1
    master against its guide (the pair at N = 32, M = 48: a 64x64 thermal
    master, a 128x128 RGB guide) on the card and on the CPU, same weights
    and noise: losses within 1e-4, every clipped gradient leaf within 1e-3
    of its largest value."""
    from lmic_tpu_torch.utils.crosscheck import (
        master_step_agreement,
        train_step_agreement,
    )

    x = _train_batch((2, 64, 128, 3), seed=12).cpu()
    xm = _train_batch((2, 64, 64, 1), seed=13).cpu()
    xg = _train_batch((2, 128, 128, 3), seed=14).cpu()
    out = {
        "cheng2020-attn": train_step_agreement("cheng2020-attn", 6, x, 8192,
                                               N=32)[:2],
        "master": master_step_agreement(7, 1, xm, xg, 10240, N=32,
                                        M=48)[:2],
    }
    for what, (loss_err, grad_err) in out.items():
        if not (loss_err < 1e-4 and grad_err < 1e-3):
            raise AssertionError(f"{what} training step on the card vs the "
                                 f"CPU: loss {loss_err:.3g}, gradients "
                                 f"{grad_err:.3g}")
    return out


def phase_ar_rgbt_training():
    """The AR family's and the RGB-T pair's training paths: each of
    mbt2018 q7, cheng2020-anchor q3, cheng2020-attn q6 and guided q7 at
    batch 16 of 256x256 in f32 and AMP, then the channel-1 master q7
    against its frozen guide (batch 4, f32). Returns the launch counts of
    the timed steps, by path."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )
    from lmic_tpu_torch.utils.train_cli import make_master_train_step

    t_phase = time.perf_counter()
    convs = _log_train_convs()
    counts = {p: {k: 0 for k in gdn.LAUNCHES}
              for p in ("ar_training", "rgbt_training")}
    batch = _train_batch(TRAIN_BATCH, seed=2)
    six = {k: 6 for k in gdn.LAUNCHES}
    for arch, q in AR_TRAIN:
        extra = {"first_stride": 2} if arch == "guided" else {}
        for mode, dtype in (("f32", None), ("amp", torch.bfloat16)):
            module = zoo.create_model(arch, q, seed=0, device="cuda",
                                      dtype=dtype, **extra).module
            opt = make_optimizer()
            state = create_train_state(module, opt)
            gen = torch.Generator(device="cuda").manual_seed(0)
            launched = _train_case(
                f"{arch} q{q} (N={module.N}, M={module.M}) {mode} batch "
                f"{TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}x{TRAIN_BATCH[2]}",
                make_train_step(module, opt, LAMBDAS[q - 1]), state,
                (batch,), gen, 4, six)
            path = "rgbt_training" if arch == "guided" else "ar_training"
            for k, v in launched.items():
                counts[path][k] += v
            del module, state, opt
    del batch
    torch.cuda.empty_cache()
    # the master: 6 gdn_fwd in the frozen guide (no backward), 6 of each
    # kernel in the master
    q = RGBT_QUALITY
    guided = zoo.create_model("guided", q, seed=0, channel=3,
                              first_stride=2, device="cuda").module
    guided.eval().requires_grad_(False)
    master = zoo.create_model("master", q, seed=1, channel=1,
                              device="cuda").module
    opt = make_optimizer()
    state = create_train_state(master, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    xm = _train_batch(MASTER_BATCH, seed=3)
    xg = _train_batch(MASTER_GUIDE, seed=4)
    launched = _train_case(
        f"master q{q} (N={master.N}, M={master.M}) channel 1 f32 batch "
        f"{MASTER_BATCH[0]} of {MASTER_BATCH[1]}x{MASTER_BATCH[2]} with "
        f"{MASTER_GUIDE[1]}x{MASTER_GUIDE[2]} guides",
        make_master_train_step(master, guided, opt, LAMBDAS[q - 1]), state,
        (xm, xg), gen, 4, {k: 12 if k == "gdn_fwd" else 6
                           for k in gdn.LAUNCHES})
    for k, v in launched.items():
        counts["rgbt_training"][k] += v
    del guided, master, state, opt, xm, xg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    agree = _train_agreement_ar_rgbt()
    log(f"card vs CPU steps: {time.perf_counter() - t0:.1f} s")
    log("AR and RGB-T training steps on the card vs the CPU (same noise): "
        + json.dumps({k: {"loss": f"{a:.3g}", "gradients": f"{b:.3g}"}
                      for k, (a, b) in agree.items()}))
    fft = [k for k, (_, _, kernels) in convs.items() if kernels]
    log(f"cuDNN's pick for the training convs runs FFT kernels at "
        f"{fft or 'no shape'}")
    log(f"AR and RGB-T training phase: {time.perf_counter() - t_phase:.1f} "
        "s")
    return counts


def _paired_codecs(family, device):
    """The `_R` guide codec (seed 0, RGB) and the `_D` codec (seed 1,
    thermal) of one family at PAIRED_QUALITY, tables built."""
    from lmic_tpu_torch import zoo

    out = []
    for suffix, channel, seed in (("_R", 3, 0), ("_D", 1, 1)):
        codec = zoo.create_model(family + suffix, PAIRED_QUALITY, seed=seed,
                                 channel=channel, device=device)
        codec.update()
        out.append(codec)
    return tuple(out)


def _paired_legs(guide_codec, codec, x, guide):
    """One direct round trip of a pair, leg by leg: the `_R` compress
    (strings and the ga* maps) and decompress (x_hat and the gs* maps),
    the `_D` compress on the ga* maps and decompress on the gs* maps.
    Returns the legs' outputs and, per leg, (name, ms, gdn_fwd launches,
    peak device memory, the codec's stats)."""
    import torch

    from lmic_tpu_torch.ops import gdn

    outs, legs = {}, []

    def leg(name, codec_, run, prefix):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = gdn.LAUNCHES["gdn_fwd"]
        t0 = time.perf_counter()
        outs[name] = run()
        torch.cuda.synchronize()
        legs.append((name, 1e3 * (time.perf_counter() - t0),
                     gdn.LAUNCHES["gdn_fwd"] - before,
                     torch.cuda.max_memory_allocated(),
                     _leg_stats(codec_, prefix)))

    leg("R compress", guide_codec, lambda: guide_codec.compress(guide),
        "enc_")
    g = outs["R compress"]
    leg("R decompress", guide_codec,
        lambda: guide_codec.decompress(g["strings"], g["shape"]), "dec_")
    leg("D compress", codec, lambda: codec.compress(x, g["hidden"]), "enc_")
    out = outs["D compress"]
    leg("D decompress", codec, lambda: codec.decompress(
        out["strings"], out["shape"], outs["R decompress"]["hidden"],
        u8=True), "dec_")
    return outs, legs


def _paired_checks(guide_codec, codec, x, guide, outs):
    """Encoding is deterministic on both codecs; each decoder recovers
    exactly its encoder's latents (`_code_y_z(..., keep_y_hat=True)`
    against `_decode_y_hat`), with the strings of its codec."""
    import torch

    from lmic_tpu_torch.models.codec import _symbols_to_host

    g, out = outs["R compress"], outs["D compress"]
    if guide_codec.compress(guide, hidden=False)["strings"] != g["strings"] \
            or codec.compress(x, g["hidden"])["strings"] != out["strings"]:
        raise AssertionError("paired encoding is not deterministic")
    with torch.inference_mode():
        ys, z_sym = guide_codec._analyze(guide)
        y, z = codec.module.analyze_fused(codec._pixels(x), g["hidden"])
        z_d = _symbols_to_host(torch.round(
            z - codec._medians(codec.eb_state)))
        for c, ys_, zs, want in ((guide_codec, ys, z_sym, g),
                                 (codec, [y], z_d, out)):
            enc = c._code_y_z(ys_, zs, keep_y_hat=True)
            dec = c._decode_y_hat(enc["strings"], enc["shape"])
            if enc["strings"] != want["strings"]:
                raise AssertionError("paired strings differ from the codec")
            if not torch.equal(dec, enc["y_hat_latent"]):
                raise AssertionError("a paired decoder did not recover the "
                                     "encoded latents")


def _paired_cpu_agreement(family, pair):
    """The pair's CUDA transforms (`g_a_hidden`, `g_s_hidden`,
    `analyze_fused`, `g_s_fused`) against the CPU's, same seeds, stage by
    stage on a small input (`utils/crosscheck.py::paired_agreement`):
    within 1e-4 of the largest value, and equal coding tables."""
    from lmic_tpu_torch.utils.crosscheck import paired_agreement

    cpu = _paired_codecs(family, "cpu")
    # the smallest side whose deepest fusion level (1/8) still holds ESA's
    # 15 pixels: twice the downsampling factor
    side = 2 * pair[1].module.downsampling_factor
    worst = paired_agreement(
        pair, cpu, _images(1, (1, side, side, 1), seed=53)[0],
        _images(1, (1, side, side, 3), seed=54)[0])
    if not worst < 1e-4:
        raise AssertionError(f"{family} pair: CUDA vs CPU transforms "
                             f"{worst:.3g}")
    for cuda, ref in zip(pair, cpu):
        for state in ("eb_state", "gc_state"):
            if not np.array_equal(getattr(cuda, state).table.cdf,
                                  getattr(ref, state).table.cdf):
                raise AssertionError(f"{family} pair: {state} tables differ")
    return worst


def _log_fuse_conv(codec):
    """The first fusion level's 5x5 conv (2N -> N at the `_D` g_a's first
    level) on the GEMM route, as the wire runs it: device ms (CUDA events)
    and the peak memory of one call above what was allocated before it."""
    import torch

    conv = codec.module.tran_conv1
    N = codec.module.N
    H, W = PAIRED_IMAGE[1] // 2, PAIRED_IMAGE[2] // 2
    with torch.inference_mode():
        x = torch.randn(1, 2 * N, H, W, device=codec.device).contiguous(
            memory_format=torch.channels_last)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        conv(x)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        ms = _time_ms(lambda: conv(x))
    log(f"paired fusion conv tran_conv1 ({2 * N} -> {N}, 5x5, {H}x{W}, "
        f"GEMM route): {ms:.3f} ms a call, peak {peak / 2**30:.2f} GiB "
        "above its input")


def phase_paired():
    """The paired RGB-T archs: one direct round trip of each `_R` -> `_D`
    pair at 512x640, then a cheng2020-attn_R f32 training path. Returns
    (the gdn_fwd launches of the timed round trips, the launch counts of
    the timed training steps)."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    t_phase = time.perf_counter()
    serve_launches = 0
    guide = _images(1, PAIRED_GUIDE, seed=51)[0]
    x = _images(1, PAIRED_IMAGE, seed=52)[0]
    for family in PAIRED:
        t_family = time.perf_counter()
        pair = _paired_codecs(family, "cuda")
        t_built = time.perf_counter() - t_family
        _paired_legs(*pair, x, guide)  # warm-up
        _reset_counts()
        outs, legs = _paired_legs(*pair, x, guide)
        counts = dict(gdn.LAUNCHES)
        launches = counts.pop("gdn_fwd")
        if launches != sum(PAIRED_LEGS) or any(counts.values()) or tuple(
                n for _, _, n, _, _ in legs) != PAIRED_LEGS:
            raise AssertionError(f"{family} pair: gdn_fwd {launches}, per "
                                 f"leg {[leg[2] for leg in legs]}, others "
                                 f"{counts}")
        serve_launches += launches
        rec = outs["D decompress"]["x_hat"]
        if rec.shape != x.shape or rec.dtype != np.uint8:
            raise AssertionError(f"{family} pair: bad decode {rec.shape}")
        _paired_checks(*pair, x, guide, outs)
        t0 = time.perf_counter()
        worst = _paired_cpu_agreement(family, pair)
        t_cpu = time.perf_counter() - t0
        nbytes = [sum(len(s) for g in outs[k]["strings"] for s in g)
                  for k in ("R compress", "D compress")]
        log(f"paired {family} q{PAIRED_QUALITY} (N={pair[1].module.N}, "
            f"M={pair[1].module.M}), guide {guide.shape[1]}x"
            f"{guide.shape[2]}, thermal {x.shape[1]}x{x.shape[2]}: guide "
            f"{nbytes[0]} bytes, thermal {nbytes[1]} bytes "
            f"({8 * nbytes[1] / (x.shape[1] * x.shape[2]):.4f} bpp); built "
            f"and updated in {t_built:.1f} s; CUDA vs CPU transforms within "
            f"{worst:.3g} ({t_cpu:.1f} s); legs " + json.dumps({
                name: {"ms": round(ms, 2), "gdn_fwd": n,
                       "peak_GiB": round(peak / 2**30, 2), "stages": st}
                for name, ms, n, peak, st in legs}))
        r_out, d_out = outs["R compress"], outs["D compress"]
        r_dec = outs["R decompress"]
        runs = {
            "R compress": lambda: pair[0].compress(guide),
            "R decompress": lambda: pair[0].decompress(
                r_out["strings"], r_out["shape"]),
            "D compress": lambda: pair[1].compress(x, r_out["hidden"]),
            "D decompress": lambda: pair[1].decompress(
                d_out["strings"], d_out["shape"], r_dec["hidden"],
                u8=True),
        }
        # a profiler session costs seconds: each leg of the first pair is
        # profiled, each other pair's round trip as one
        if family == PAIRED[0]:
            for name, run in runs.items():
                _log_rgbt_profile(f"paired {family} {name}", run)
            _log_fuse_conv(pair[1])
        else:
            _log_rgbt_profile(f"paired {family} round trip", lambda: [
                run() for run in runs.values()])
        log(f"paired {family}: {time.perf_counter() - t_family:.1f} s")
        del pair, outs, r_out, d_out, r_dec
        torch.cuda.empty_cache()

    arch, q = PAIRED_TRAIN
    module = zoo.create_model(arch, q, seed=0, device="cuda").module
    opt = make_optimizer()
    state = create_train_state(module, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = _train_batch(TRAIN_BATCH, seed=5)
    train = _train_case(
        f"{arch} q{q} (N={module.N}, M={module.M}) f32 batch "
        f"{TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}x{TRAIN_BATCH[2]}",
        make_train_step(module, opt, LAMBDAS[q - 1]), state, (batch,), gen,
        4, {k: 6 for k in gdn.LAUNCHES})
    del module, state, opt, batch
    torch.cuda.empty_cache()
    log(f"paired phase: {time.perf_counter() - t_phase:.1f} s")
    return serve_launches, train


def _gops(n, shape=None, seed=0):
    """Seeded uint8 GOPs of `shape` (default VIDEO_GOP): a smooth frame
    with noise that moves a few pixels a frame, with fresh noise on
    each."""
    rng = np.random.default_rng(seed + 1000)
    B, T, H, W, C = shape or VIDEO_GOP
    out = []
    for i in range(n):
        base = _images(1, (1, H, W, C), seed=seed + i)[0][0]
        dy, dx = rng.integers(-4, 5, 2)
        frames = [np.clip(np.roll(base, (t * dy, t * dx), (0, 1))
                          + rng.normal(0, 3, base.shape), 0, 255)
                  for t in range(T)]
        out.append(np.stack(frames).astype(np.uint8)[None])
    return out


def _gop_bytes(strings):
    """(keyframe bytes, inter-frame bytes of each inter frame)."""
    def n(groups):
        return sum(len(s) for g in groups for s in g)

    return n(strings[0]), [n(f["motion"]) + n(f["residual"])
                           for f in strings[1:]]


def _log_video_profile(what, run):
    """One leg's device ms (torch.profiler), busy share of its wall ms,
    device operations and largest kernels; returns the GDN device ms."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    gdn_ms, dev_ms, _, top, ops = _profile(run, n=1, keep=10)
    log(f"video profile {what}: device {dev_ms:.2f} ms of wall "
        f"{wall_ms:.2f} ms (busy {100 * dev_ms / wall_ms:.1f} %), "
        f"{ops:.0f} device operations, GDN {gdn_ms:.3f} ms; device ms of "
        "the largest kernels: "
        + json.dumps({k: round(v, 3) for k, v in top.items()}))
    return gdn_ms


def _log_blur(n=10):
    """The 11x11 depthwise Gaussian blur of the scale-space volume at
    full size, as the warp runs it: its device kernels and ms. The
    profile is of a second cycle of `n` calls: a session can drop its
    first operations, and a blur is a few of them."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from lmic_tpu_torch.ops import video

    _, _, H, W, C = VIDEO_GOP
    x = torch.rand(1, C, H, W, device="cuda").contiguous(
        memory_format=torch.channels_last)
    kernel = video.gaussian_kernel2d(11, 1.5, device="cuda")
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                for _ in range(n):
                    video.gaussian_blur(x, kernel)
                torch.cuda.synchronize()
                prof.step()
        ms = _time_ms(lambda: video.gaussian_blur(x, kernel))
    kernels = {evt.key[:60]: round(evt.self_device_time_total / 1e3 / n, 3)
               for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA
               and not evt.is_user_annotation}
    ops = sum(evt.count for evt in prof.key_averages()
              if evt.device_type == DeviceType.CUDA
              and not evt.is_user_annotation) / n
    if not kernels:
        raise AssertionError("the profiler recorded no device time")
    log(f"video blur 11x11 depthwise at {W}x{H}: {ms:.3f} ms a call "
        f"(CUDA events), {ops:.0f} device operations a call: "
        + json.dumps(kernels))


def phase_video_serving():
    """ssf2020 served by `serve.main --checkpoint` from a file that
    `update_model_file` finalized: three 1080p GOPs through POST /compress
    and /decompress. Returns the GDN launches of the served requests
    (there must be none)."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils import serve
    from lmic_tpu_torch.utils.checkpoint import update_model_file
    from lmic_tpu_torch.utils.crosscheck import video_agreement

    t_phase = time.perf_counter()
    codec = zoo.create_video_model("ssf2020", 1, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        path = update_model_file(tmp, codec, "ssf2020-q1")
        started, ready = [], threading.Event()
        thread = threading.Thread(
            target=serve.main,
            args=(["--checkpoint", path, "-a", "ssf2020", "--port", "0"],),
            kwargs={"started": lambda srv: (started.append(srv),
                                            ready.set())},
            daemon=True)
        thread.start()
        if not ready.wait(300):
            raise AssertionError("the video server did not start")
        server = started[0]
        direct, _ = serve.load_checkpoint_codec(path, "ssf2020")
    t_built = time.perf_counter() - t_phase
    served, port = server.codec, server.server_address[1]
    try:
        gops = _gops(VIDEO_REQUESTS)
        payloads = []
        for gop in gops:
            buf = io.BytesIO()
            serve._write_pixels(buf, gop)
            payloads.append(buf.getvalue())
        _post(port, "/decompress", _post(port, "/compress", payloads[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        requests = []
        for payload in payloads:
            t0 = time.perf_counter()
            body = _post(port, "/compress", payload)
            t1 = time.perf_counter()
            enc = _leg_stats(served, "enc_")
            rec = _post(port, "/decompress", body)
            t2 = time.perf_counter()
            requests.append((body, rec, 1e3 * (t1 - t0), 1e3 * (t2 - t1),
                             enc, _leg_stats(served, "dec_")))
        torch.cuda.synchronize()
        counts = dict(gdn.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        thread.join(60)
    if thread.is_alive():
        raise AssertionError("the video server did not stop")
    if any(counts.values()):
        raise AssertionError(f"video serving launched GDN kernels {counts}")
    _, T, H, W, _ = VIDEO_GOP
    for i, (gop, (body, rec, c_ms, d_ms, enc, dec)) in enumerate(
            zip(gops, requests)):
        strings, shapes = serve._decode_request(io.BytesIO(body), True)
        if serve._encode_response((strings, shapes), True) != body:
            raise AssertionError("the body does not parse back to itself")
        got = serve._read_pixels(io.BytesIO(rec))
        if got.shape != gop.shape or got.dtype != np.uint8:
            raise AssertionError(f"bad /decompress {got.shape} {got.dtype}")
        direct_out = direct.compress(gop)
        if serve._encode_response(direct_out, True) != body \
                or direct.compress(gop) != direct_out:
            raise AssertionError("video bodies differ from the direct "
                                 "calls, or encoding is not deterministic")
        if not np.array_equal(direct.decompress(strings, shapes, u8=True),
                              got):
            raise AssertionError("/decompress differs from the direct call")
        with torch.inference_mode():
            _, recs = direct._encode_gop(direct._frames(gop))
            in_loop = torch.stack(recs, 1).permute(0, 1, 3, 4, 2).cpu()
        f32 = direct.decompress(strings, shapes)
        if not np.array_equal(f32, in_loop.numpy()):
            raise AssertionError("the decoder's frames differ from the "
                                 "encoder's in-loop reconstructions")
        level = np.abs(got.astype(np.float64)
                       - np.clip(f32, 0.0, 1.0) * 255.0).max()
        if not np.isfinite(f32).all() or level > 1.0:
            raise AssertionError(f"uint8 frames {level:.3f} levels off")
        key, inter = _gop_bytes(strings)
        log(f"video request {i}: /compress {c_ms:.1f} ms, /decompress "
            f"{d_ms:.1f} ms; keyframe {key} bytes "
            f"({8 * key / (H * W):.4f} bpp), inter frames {inter} bytes "
            f"({[round(8 * b / (H * W), 4) for b in inter]} bpp); stages "
            + json.dumps({**enc, **dec}))
    t0 = time.perf_counter()
    cpu = zoo.create_video_model("ssf2020", 1, seed=0, device="cpu")
    cpu.update()  # the tables are built on the CPU on both
    for which, hp in codec.hp_states.items():
        if not np.array_equal(hp.eb_state.table.cdf,
                              cpu.hp_states[which].eb_state.table.cdf):
            raise AssertionError(f"video {which} tables differ")
    worst = video_agreement(codec, cpu, _gops(1, VIDEO_CHECK, seed=7)[0])
    if not worst < 1e-4:
        raise AssertionError(f"video: CUDA vs CPU stages {worst:.3g}")
    log(f"video ssf2020 q1 (192 latent, 128 mid planes), {T} frames of "
        f"{W}x{H}, served from {os.path.basename(path)}: built, finalized "
        f"and loaded in {t_built:.1f} s; 0 GDN launches; peak "
        f"{peak / 2**30:.2f} GiB; CUDA vs CPU stages within {worst:.3g} "
        f"({time.perf_counter() - t0:.1f} s)")
    gop = gops[0]
    strings, shapes = direct.compress(gop)
    _log_video_profile("compress", lambda: direct.compress(gop))
    _log_video_profile("decompress", lambda: direct.decompress(
        strings, shapes, u8=True))
    _log_blur()
    del codec, direct, served, server, cpu
    torch.cuda.empty_cache()
    log(f"video phase: {time.perf_counter() - t_phase:.1f} s")
    return sum(counts.values())


def _counted(fn, *args, **kwargs):
    """(fn's result, the GDN launches it made, its host ms to a
    synchronize)."""
    import torch

    from lmic_tpu_torch.ops import gdn

    before = dict(gdn.LAUNCHES)
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    return out, {k: gdn.LAUNCHES[k] - before[k] for k in before}, ms


def _only_fwd(what, counts, n):
    """Exactly n gdn_fwd launches and no backward kernel."""
    rest = {k: v for k, v in counts.items() if k != "gdn_fwd"}
    if counts["gdn_fwd"] != n or any(rest.values()):
        raise AssertionError(f"{what}: launches {counts}, want {n} gdn_fwd")


def _write_yuv_clip(path, frames, H, W, seed=0):
    """A seeded 8-bit YUV420 clip: moving smooth frames with noise
    (`_gops`), BT.709 with 2x2 average-pool chroma."""
    import torch

    from lmic_tpu_torch.transforms import rgb2ycbcr, yuv_444_to_420

    gop = _gops(1, (1, frames, H, W, 3), seed=seed)[0][0]
    with open(path, "wb") as f:
        for frame in gop:
            rgb = torch.from_numpy(frame[None].astype(np.float32) / 255)
            for p in yuv_444_to_420(rgb2ycbcr(rgb)):
                np.clip(np.round(p[0, :, :, 0].numpy() * 255), 0, 255
                        ).astype(np.uint8).tofile(f)


def _check_video_docs(outdir, stem, desc):
    """lmic_tpu's video-eval schema: the per-sequence document and the
    cumulative one (tests/test_eval_golden.py::test_video_eval_golden)."""
    with open(os.path.join(outdir, f"ssf2020-mse-{desc}.json")) as f:
        doc = json.load(f)
    with open(os.path.join(outdir, f"{stem}-ssf2020-mse-1-{desc}.json")) as f:
        seq_doc = json.load(f)
    keys = {"psnr-y", "psnr-u", "psnr-v", "psnr-yuv", "mse-rgb", "psnr-rgb",
            "ms-ssim-rgb", "bitrate", "encoding_time", "decoding_time"}
    res = doc["results"]
    if (doc["name"] != "ssf2020-mse"
            or doc["description"] != f"Inference ({desc})"
            or res.get("q") != [f"ssf2020-mse-1-{desc}"]
            or set(res) != keys | {"q"}
            or any(len(res[k]) != 1 or not np.isfinite(res[k][0])
                   for k in keys)
            or set(seq_doc) != {"source", "name", "description", "results"}
            or set(seq_doc["results"]) != keys):
        raise AssertionError(f"video eval ({desc}) documents: {doc}")
    return {k: round(v[0], 4) for k, v in res.items() if k != "q"}


def _parse_file(data, ref, master=False):
    """A container's (shape, strings) from its bytes, after its header."""
    from lmic_tpu_torch.utils import codec_cli as cc

    f = io.BytesIO(data)
    if not ref:
        cc.read_uints(f, 1)
    cc.read_uchars(f, 2)
    cc.read_uints(f, 2)
    cc.read_uchars(f, 2 if master and not ref else 1)
    if master:
        cc.read_floats(f, 2 * cc.SIDE)
    shape, strings = (cc.read_body_ref if ref else cc.read_body)(f)
    if f.read():
        raise AssertionError("bytes left after the body")
    return tuple(shape), strings


def _after_ids(f):
    """A reference container positioned after its two id bytes."""
    f.read(2)
    return f


def _ar_latents(codec, ys, z_sym, order, strings):
    """The AR decoder of `order` recovers exactly its encoder's latents,
    and the encoder gives `strings`. Returns the decoded latent."""
    import torch

    with torch.inference_mode():
        enc = codec._code_y_z(ys, z_sym, keep_y_hat=True, order=order)
        dec = codec._decode_y_hat(enc["strings"], enc["shape"], order)
    if enc["strings"] != strings:
        raise AssertionError(f"{order} encoding differs from the file's")
    if not torch.equal(dec, enc["y_hat_latent"]):
        raise AssertionError(f"the {order} decode did not recover the "
                             "encoded latents")
    return dec


def _files(codec, ar, guided, master, x, xm, guide, steps):
    """Every container through the array-level cores (no PIL): the file
    parses back to its codec's strings, its decode recovers the encoder's
    latents and equals a direct decompress. Returns the raster loops' ms
    per latent pixel."""
    import torch

    from lmic_tpu_torch.models.codec import _symbols_to_host
    from lmic_tpu_torch.utils import codec_cli as cc

    for ref in (False, True):
        f = io.BytesIO()
        t0 = time.perf_counter()
        (cc.write_image_ref if ref else cc.write_image)(
            f, x, codec, "mbt2018-mean", EVAL_QUALITY)
        t1 = time.perf_counter()
        shape, strings = _parse_file(f.getvalue(), ref)
        out = codec.compress(x)
        if (shape, strings) != (tuple(out["shape"]), out["strings"]):
            raise AssertionError("mbt2018-mean file != its codec's strings")
        f.seek(0)
        t2 = time.perf_counter()
        got = (cc.read_image_ref(_after_ids(f), lambda a, q: codec,
                                 "mbt2018-mean", EVAL_QUALITY) if ref
               else cc.read_image(f, lambda a, q: codec)[0])
        t3 = time.perf_counter()
        _roundtrip_checks(codec, x, strings, shape)
        if not np.array_equal(got, codec.decompress(strings, shape)["x_hat"]):
            raise AssertionError("mbt2018-mean file decode != decompress")
        steps[f"file mbt2018-mean {'ref' if ref else 'native'}"] = (
            round(1e3 * (t1 - t0), 1), round(1e3 * (t3 - t2), 1))
    # mbt2018 in the reference container: the raster order
    f = io.BytesIO()
    t0 = time.perf_counter()
    cc.write_image_ref(f, x, ar, "mbt2018", EVAL_QUALITY)
    t1 = time.perf_counter()
    enc_loop = ar.stats["enc_loop_ms"]
    shape, strings = _parse_file(f.getvalue(), True)
    f.seek(0)
    t2 = time.perf_counter()
    got = cc.read_image_ref(_after_ids(f), lambda a, q: ar, "mbt2018",
                            EVAL_QUALITY)
    t3 = time.perf_counter()
    dec_stats = {k: ar.stats[k] for k in ("dec_loop_ms",
                                          "dec_loop_device_ms",
                                          "dec_loop_rans_ms")}
    with torch.inference_mode():
        ys, z_sym = ar._analyze(x)
    dec = _ar_latents(ar, ys, z_sym, "raster", strings)
    with torch.inference_mode():
        if not np.array_equal(got, ar._synthesize(dec, False)["x_hat"]):
            raise AssertionError("mbt2018 raster file decode != decompress")
    pixels = (x.shape[1] // 16) * (x.shape[2] // 16)
    raster = {"mbt2018 encode": enc_loop / pixels,
              "mbt2018 decode": dec_stats["dec_loop_ms"] / pixels,
              "mbt2018 decode device": dec_stats["dec_loop_device_ms"]
              / pixels,
              "mbt2018 decode rans": dec_stats["dec_loop_rans_ms"] / pixels}
    steps["file mbt2018 ref (raster)"] = (round(1e3 * (t1 - t0), 1),
                                          round(1e3 * (t3 - t2), 1))
    # the master pair: native (wavefront) and reference (raster)
    for ref in (False, True):
        order = "raster" if ref else "wavefront"
        f = io.BytesIO()
        t0 = time.perf_counter()
        (cc.write_rgbt_ref if ref else cc.write_rgbt)(
            f, xm, guide, guided, master, RGBT_QUALITY, channel=1)
        t1 = time.perf_counter()
        enc_loop = master.stats["enc_loop_ms"]
        shape, strings = _parse_file(f.getvalue(), ref, master=True)
        f.seek(0)
        t2 = time.perf_counter()
        args = (lambda ch: guide, lambda ch: guided, lambda ch: master)
        got = (cc.read_rgbt_ref(_after_ids(f), *args, channel=1) if ref
               else cc.read_rgbt(f, *args))
        t3 = time.perf_counter()
        dec_loop = master.stats["dec_loop_ms"]
        g = cc._code_guide(guided, guide)
        with torch.inference_mode():
            feat, align, _, _ = master.module.features(master._pixels(xm),
                                                       g["x_hat"])
            y, z = master.module.analyze_features(feat, align)
            z_sym = _symbols_to_host(
                torch.round(z - master._medians(master.eb_state)))
        _ar_latents(master, [y], z_sym, order, strings)
        m = master.compress(xm, g["x_hat"], order=order)
        if m["strings"] != strings:
            raise AssertionError(f"master {order} file != its strings")
        if not np.array_equal(got, master.decompress(m, g,
                                                     order=order)["x_hat"]):
            raise AssertionError(f"master {order} file decode != "
                                 "decompress")
        steps[f"file master {'ref (raster)' if ref else 'native'}"] = (
            round(1e3 * (t1 - t0), 1), round(1e3 * (t3 - t2), 1))
        if ref:
            mp = (xm.shape[1] // 16) * (xm.shape[2] // 16)
            raster.update({"master encode": enc_loop / mp,
                           "master decode": dec_loop / mp})
    return {k: round(v, 4) for k, v in raster.items()}


def _serve_master(guided, master, xm, guide, tmp):
    """uint8 pixels xm, guide. The pair finalized with `update_model_file` and served by
    `serve.main -a master --guided-checkpoint --channel 1` in a thread:
    one pair through /compress and /decompress, the bodies equal to the
    direct calls. Returns (compress ms, decompress ms)."""
    from lmic_tpu_torch.utils import serve
    from lmic_tpu_torch.utils.checkpoint import update_model_file
    from lmic_tpu_torch.utils.codec_cli import write_body, write_floats

    gk = update_model_file(tmp, guided, "guided")
    mk = update_model_file(tmp, master, "master")
    started, ready = [], threading.Event()
    thread = threading.Thread(
        target=serve.main,
        args=(["--checkpoint", mk, "-a", "master", "--guided-checkpoint", gk,
               "--channel", "1", "-q", str(RGBT_QUALITY), "--port", "0"],),
        kwargs={"started": lambda s: (started.append(s), ready.set())},
        daemon=True)
    thread.start()
    t0 = time.perf_counter()
    while not ready.wait(1):
        if not thread.is_alive() or time.perf_counter() - t0 > 300:
            raise AssertionError("the RGB-T server did not start")
    server = started[0]
    try:
        px, pg = io.BytesIO(), io.BytesIO()
        serve._write_pixels(px, xm)
        serve._write_pixels(pg, guide)
        t0 = time.perf_counter()
        body = _post(server.server_address[1], "/compress",
                     px.getvalue() + pg.getvalue())
        t1 = time.perf_counter()
        rec = _post(server.server_address[1], "/decompress",
                    body + pg.getvalue())
        t2 = time.perf_counter()
    finally:
        server.shutdown()
        thread.join(60)
    if thread.is_alive():
        raise AssertionError("the RGB-T server did not stop")
    g_out = guided.compress(guide, hidden=False, reconstruct=True)
    m = master.compress(xm, g_out["x_hat"])
    want = io.BytesIO()
    write_body(want, m["shape"], m["strings"])
    write_floats(want, m["beta"].reshape(-1).tolist())
    write_floats(want, m["gamma"].reshape(-1).tolist())
    if body != want.getvalue():
        raise AssertionError("served /compress != the direct calls")
    pix = master.decompress(m, {"x_hat": g_out["x_hat"],
                                "hidden": g_out["hidden_dec"]},
                            u8=True)["x_hat"]
    if not np.array_equal(serve._read_pixels(io.BytesIO(rec)), pix):
        raise AssertionError("served /decompress != the direct call")
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def phase_eval_and_files():
    """Evaluation and file coding: the eval functions and CLIs, the
    containers through their array-level cores, the master pair served
    from its two finalized checkpoints. Returns the gdn_fwd launches of
    the phase (each leg's count is checked on its own)."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils import codec_cli as cc
    from lmic_tpu_torch.utils import eval_model, metrics, video_eval
    from lmic_tpu_torch.utils.serve import load_rgbt_codecs

    t_phase = time.perf_counter()
    codec = zoo.create_model("mbt2018-mean", EVAL_QUALITY, seed=0,
                             device="cuda")
    ar = zoo.create_model("mbt2018", EVAL_QUALITY, seed=0, device="cuda")
    (guided, master), _ = load_rgbt_codecs(RGBT_QUALITY, 1, seed=0,
                                           device="cuda")
    r, d = _paired_codecs("mbt2018", "cuda")
    for c in (codec, ar):
        c.update()
    images = [im.astype(np.float32) / 255
              for im in _images(EVAL_IMAGES, IMAGE, seed=41)]
    xm_u8 = _images(1, RGBT_MASTER, seed=42)[0]
    guide_u8 = _images(1, RGBT_GUIDE, seed=43)[0]
    xm = xm_u8.astype(np.float32) / 255
    guide = guide_u8.astype(np.float32) / 255
    xp = _images(1, PAIRED_IMAGE, seed=44)[0].astype(np.float32) / 255
    gp = _images(1, PAIRED_GUIDE, seed=45)[0].astype(np.float32) / 255
    log(f"eval phase: codecs built in {time.perf_counter() - t_phase:.1f} s")
    # warm-up: one call of each eval leg, uncounted
    eval_model.eval_image_codec(codec, images[0])
    eval_model.eval_rgbt_pair(guided, master, xm, guide)
    eval_model.eval_rd_pair(r, d, xp, gp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    steps, results = {}, {}

    # image eval: 6 gdn_fwd an image in each mode
    for i, x in enumerate(images):
        for mode, fn in (("estimate", eval_model.eval_image_forward),
                         ("coder", eval_model.eval_image_codec)):
            m, counts, ms = _counted(fn, codec, x)
            _only_fwd(f"image eval ({mode})", counts, 6)
            steps[f"image {i} {mode}"] = round(ms, 1)
            results[f"image {i} {mode}"] = {k: round(v, 5)
                                            for k, v in m.items()}
            if mode == "coder":
                out = codec.compress(x)
                n = sum(len(s) for g in out["strings"] for s in g)
                if m["bpp"] != 8.0 * n / (x.shape[1] * x.shape[2]):
                    raise AssertionError(f"eval bpp {m['bpp']} != 8 x "
                                         f"{n} bytes")
    cpu = zoo.create_model("mbt2018-mean", EVAL_QUALITY, seed=0,
                           device="cpu")
    xs = _images(1, EVAL_CHECK, seed=46)[0].astype(np.float32) / 255
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # ms-ssim below 161 px
        on_card = eval_model.eval_image_forward(codec, xs)
        on_cpu = eval_model.eval_image_forward(cpu, xs)
    worst = max(abs(on_card[k] - on_cpu[k]) / abs(on_cpu[k])
                for k in on_cpu)
    if not worst < 1e-4:
        raise AssertionError(f"eval estimate card vs CPU {worst:.3g}: "
                             f"{on_card} {on_cpu}")
    del cpu

    # RGB-T eval: the pair, 12 gdn_fwd in each mode (9 + 3 coding)
    m, counts, ms = _counted(eval_model.eval_rgbt_pair, guided, master, xm,
                             guide, True)
    steps["rgbt estimate"] = round(ms, 1)
    results["rgbt estimate"] = m
    rgbt_ee = counts["gdn_fwd"]
    marks, decompress = [], master.decompress
    master.decompress = lambda *a, **k: (marks.append(
        gdn.LAUNCHES["gdn_fwd"]), decompress(*a, **k))[1]
    try:
        start = gdn.LAUNCHES["gdn_fwd"]
        m, counts, ms = _counted(eval_model.eval_rgbt_pair, guided, master,
                                 xm, guide)
    finally:
        del master.decompress
    split = (marks[0] - start, start + counts["gdn_fwd"] - marks[0])
    _only_fwd("rgbt eval (coder)", counts, 12)
    if split != (9, 3):
        raise AssertionError(f"rgbt eval launches {split}, want (9, 3)")
    steps["rgbt coder"] = round(ms, 1)
    results["rgbt coder"] = m
    # the paired `_R` -> `_D` eval: 15 with the coder
    m, counts, ms = _counted(eval_model.eval_rd_pair, r, d, xp, gp)
    _only_fwd("paired eval (coder)", counts, 15)
    steps["paired coder"] = round(ms, 1)
    results["paired coder"] = m
    m, counts, ms = _counted(eval_model.eval_rd_pair, r, d, xp, gp, True)
    steps["paired estimate"] = round(ms, 1)
    results["paired estimate"] = m
    paired_ee = counts["gdn_fwd"]
    log(f"eval gdn_fwd launches: estimate of the RGB-T pair {rgbt_ee}, "
        f"of the paired archs {paired_ee}")
    del r, d

    with tempfile.TemporaryDirectory() as tmp:
        # video: video_eval.main in both modes, then lmic-torch-codec in
        # both containers on a seeded 1080p clip; no GDN
        T, H, W = VIDEO_CLIP
        stem = f"clip_{W}x{H}_30_yuv420"
        clip = os.path.join(tmp, stem + ".yuv")
        _write_yuv_clip(clip, T, H, W, seed=47)
        video = zoo.create_video_model("ssf2020", 1, seed=0, device="cuda")
        ckpt = os.path.join(tmp, "ssf2020-train.ckpt")
        torch.save({"params": video.module.state_dict()}, ckpt)
        video.update()
        outdir = os.path.join(tmp, "video")
        for desc, flag in (("ans", []), ("entropy-estimation",
                                         ["--entropy-estimation"])):
            _, counts, ms = _counted(video_eval.main, [
                "-d", clip, "--gop", "3", "-o", outdir, "--checkpoint", ckpt]
                + flag)
            _only_fwd(f"video eval ({desc})", counts, 0)
            steps[f"video eval {desc}"] = round(ms, 1)
            results[f"video eval {desc}"] = _check_video_docs(outdir, stem,
                                                              desc)
        from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence

        seq = RawVideoSequence.from_file(clip)
        with torch.inference_mode():
            want = np.concatenate([
                p.ravel() for x_ref, _ in cc.code_frames(video, seq, T)
                for p in cc._rgb_to_yuv420_planes(
                    cc.crop_center(x_ref.permute(0, 2, 3, 1), H, W))])
        seq.close()
        for container in ("lmic", "reference"):
            path = os.path.join(tmp, f"{container}.bin")
            rec = os.path.join(tmp, f"{container}.yuv")
            _, counts, enc_ms = _counted(cc.main, [
                "encode", clip, "-o", path, "--arch", "ssf2020",
                "--container", container])
            _, counts2, dec_ms = _counted(cc.main, ["decode", path, "-o",
                                                    rec])
            _only_fwd(f"video files ({container})",
                      {k: counts[k] + counts2[k] for k in counts}, 0)
            if not np.array_equal(np.fromfile(rec, np.uint8), want):
                raise AssertionError(f"video file ({container}) planes != "
                                     "the encoder's in-loop frames")
            steps[f"video file {container}"] = (round(enc_ms, 1),
                                                round(dec_ms, 1))
            results[f"video file {container} bytes"] = os.path.getsize(path)
        del video

        # files through the array-level cores, then the master pair served
        raster = _files(codec, ar, guided, master, images[0], xm, guide,
                        steps)
        steps["serve master (compress, decompress)"] = tuple(
            round(v, 1) for v in _serve_master(guided, master, xm_u8,
                                               guide_u8, tmp))
    torch.cuda.synchronize()
    counts = dict(gdn.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if any(v for k, v in counts.items() if k != "gdn_fwd"):
        raise AssertionError(f"eval and files launched backward {counts}")

    # the metric's cost: ms-ssim (f64 sums) on the card
    msssim = {}
    for name, shape in (("512x768", IMAGE), ("1080p", (1, 1080, 1920, 3))):
        a = torch.rand(shape, device="cuda")
        b = torch.clamp(a + 0.05 * torch.randn_like(a), 0, 1)
        msssim[name] = round(_time_ms(lambda: metrics.ms_ssim(a, b), runs=5,
                                      warmup=2), 3)
    log("eval and files: step ms " + json.dumps(steps))
    log("eval and files: results " + json.dumps(results))
    log(f"eval and files: card vs CPU estimate within {worst:.3g} "
        f"({on_card}); raster loops ms per latent pixel "
        + json.dumps(raster) + "; ms-ssim device ms " + json.dumps(msssim)
        + f"; peak {peak / 2**30:.2f} GiB; {counts['gdn_fwd']} gdn_fwd "
        "launches")
    del codec, ar, guided, master
    torch.cuda.empty_cache()
    log(f"eval and files phase: {time.perf_counter() - t_phase:.1f} s")
    return counts["gdn_fwd"]


def _pipe_batches(n):
    """n batches of PIPE_BATCH: two distinct ones, alternating; the first
    holds B / 4 seeded images and their mirror images about each axis,
    the second its images turned half a circle."""
    B, H, W, C = PIPE_BATCH
    base = np.concatenate(_images(B // 4, (1, H, W, C), seed=12))
    first = np.concatenate([base, base[:, ::-1], base[:, :, ::-1],
                            base[:, ::-1, ::-1]])
    pair = (first, np.ascontiguousarray(first[:, ::-1, ::-1]))
    return [pair[i % 2] for i in range(n)]


def _batch_launches(B):
    """gdn_fwd launches of one batch's round trip: 3 an image to encode
    (the analysis runs per image), 3 a batch to decode (the synthesis
    runs batched); 6 an image at B = 1."""
    return 3 * B + 3


def _sync_loop(codec, batches):
    """compress then decompress(u8=True) of each batch: (outputs, pixels,
    seconds to a synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, recs = [], []
    for x in batches:
        outs.append(codec.compress(x))
        recs.append(codec.decompress(outs[-1]["strings"], outs[-1]["shape"],
                                     u8=True)["x_hat"])
    torch.cuda.synchronize()
    return outs, recs, time.perf_counter() - t0


def _pipelined_loop(codec, batches):
    """bench.py's bench_pipelined loop: compress_async of batch i+1, then
    the finalize of batch i (host rANS), then decompress_async of batch
    i, joining batch i-1's decode: (outputs, pixels, seconds to a
    synchronize)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, recs = [], []
    pending, prev = codec.compress_async(batches[0]), None
    for i in range(len(batches)):
        nxt = (codec.compress_async(batches[i + 1])
               if i + 1 < len(batches) else None)
        out = pending()
        outs.append(out)
        dec = codec.decompress_async(out["strings"], out["shape"])
        if prev is not None:
            recs.append(prev()["x_hat"])
        prev, pending = dec, nxt
    recs.append(prev()["x_hat"])
    torch.cuda.synchronize()
    return outs, recs, time.perf_counter() - t0


def _same_outputs(what, outs, recs, want_outs, want_recs):
    """Strings and uint8 pixels equal, batch i against want's i % len."""
    for i, (out, rec) in enumerate(zip(outs, recs)):
        j = i % len(want_outs)
        if out["strings"] != want_outs[j]["strings"] \
                or tuple(out["shape"]) != tuple(want_outs[j]["shape"]):
            raise AssertionError(f"{what}: batch {i}'s strings differ")
        if not np.array_equal(rec, want_recs[j]):
            raise AssertionError(f"{what}: batch {i}'s pixels differ")


def _pipelined_serving(arch, batches, threads=("0", "1")):
    """One arch at PIPE_BATCH: the synchronous loop, then the pipelined
    loop with LMIC_DECODE_THREAD at each of `threads` (off, on), each
    byte-equal to the synchronous outputs with exact launch counts.
    Returns (codec, sync outputs, sync pixels, gdn_fwd launches)."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn

    B = PIPE_BATCH[0]
    per_batch = _batch_launches(B)
    codec = zoo.create_model(arch, QUALITY, seed=0, device="cuda")
    codec.update()
    _sync_loop(codec, batches[:1])  # warm-up
    torch.cuda.reset_peak_memory_stats()
    launched = 0
    _reset_counts()
    outs, recs, t_sync = _sync_loop(codec, batches[:SYNC_BATCHES])
    _only_fwd(f"{arch} synchronous", dict(gdn.LAUNCHES),
              per_batch * SYNC_BATCHES)
    launched += gdn.LAUNCHES["gdn_fwd"]
    stages = {k: round(v, 1) for k, v in codec.stats.items()}
    rates = {"sync": B * SYNC_BATCHES / t_sync}
    saved = os.environ.get("LMIC_DECODE_THREAD")
    try:
        for threaded in threads:
            os.environ["LMIC_DECODE_THREAD"] = threaded
            _reset_counts()
            p_outs, p_recs, t = _pipelined_loop(codec, batches)
            _only_fwd(f"{arch} pipelined, thread {threaded}",
                      dict(gdn.LAUNCHES), per_batch * len(batches))
            launched += gdn.LAUNCHES["gdn_fwd"]
            _same_outputs(f"{arch} pipelined, thread {threaded}", p_outs,
                          p_recs, outs, recs)
            rates[f"pipelined_thread_{threaded}"] = B * len(batches) / t
    finally:
        if saved is None:
            os.environ.pop("LMIC_DECODE_THREAD", None)
        else:
            os.environ["LMIC_DECODE_THREAD"] = saved
    peak = torch.cuda.max_memory_allocated()
    _, dev_ms, wall, top, ops = _profile(
        lambda: _sync_loop(codec, batches[:1]), n=1, keep=5)
    off_ms = 1e3 * B / rates["pipelined_thread_0"]
    log(f"pipelined {arch} q{QUALITY}, {B} x {PIPE_BATCH[1]}x"
        f"{PIPE_BATCH[2]} uint8 a batch: images/s "
        + json.dumps({k: round(v, 2) for k, v in rates.items()})
        + f"; a synchronous batch {wall:.1f} ms, device {dev_ms:.1f} ms "
        f"(busy {100 * dev_ms / wall:.1f} %, {ops:.0f} device "
        f"operations), pipelined (thread off) {off_ms:.1f} ms a batch "
        f"(device share {100 * dev_ms / off_ms:.1f} %); peak "
        f"{peak / 2**30:.2f} GiB; stages of a synchronous batch "
        + json.dumps(stages) + "; largest kernels "
        + json.dumps({k: round(v, 2) for k, v in top.items()}))
    return codec, outs, recs, launched


def _bundle_size(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _export(codec, path, shape):
    """Export a bundle on the card: (seconds, MiB on disk)."""
    from lmic_tpu_torch.utils.aot import export_serving_bundle

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        export_serving_bundle(codec, path, shape)
    return time.perf_counter() - t0, _bundle_size(path) / 2**20


def _gdn_nodes(codec):
    """gdn_fwd operator nodes of a loaded hyperprior bundle's graphs that
    hold GDN: {graph name: count}."""
    import torch

    graphs = {"_analyze_u8__one": codec._analyze_u8.inner,
              "_synth_u8__i8": codec._synth_u8.fns[torch.int8],
              "_synth_u8__i16": codec._synth_u8.fns[torch.int16]}
    return {name: sum(n.target == torch.ops.lmic_tpu_torch.gdn_fwd.default
                      for n in g.graph.nodes) for name, g in graphs.items()}


def _serve_bundle(path, live, images):
    """`serve.main --bundle` in a thread: BUNDLE_REQUESTS images through
    POST /compress and /decompress, each body equal to the live codec's
    strings and its pixels to the live codec's decode. Returns the
    gdn_fwd launches of the requests, their ms and the served graphs'
    gdn_fwd nodes."""
    import torch

    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils import serve

    started, ready = [], threading.Event()
    thread = threading.Thread(
        target=serve.main, args=(["--bundle", path, "--port", "0"],),
        kwargs={"started": lambda srv: (started.append(srv), ready.set())},
        daemon=True)
    thread.start()
    if not ready.wait(300):
        raise AssertionError("the bundle server did not start")
    server = started[0]
    nodes = _gdn_nodes(server.codec)
    try:
        port = server.server_address[1]
        payloads = []
        for x in images:
            buf = io.BytesIO()
            serve._write_pixels(buf, x)
            payloads.append(buf.getvalue())
        torch.cuda.synchronize()
        _reset_counts()
        bodies, ms = [], []
        for payload in payloads:
            t0 = time.perf_counter()
            body = _post(port, "/compress", payload)
            t1 = time.perf_counter()
            rec = _post(port, "/decompress", body)
            ms.append((round(1e3 * (t1 - t0), 1),
                       round(1e3 * (time.perf_counter() - t1), 1)))
            bodies.append((body, rec))
        torch.cuda.synchronize()
        counts = dict(gdn.LAUNCHES)
    finally:
        server.shutdown()
        thread.join(60)
    if thread.is_alive():
        raise AssertionError("the bundle server did not stop")
    _only_fwd("served bundle", counts, 6 * len(images))
    for x, (body, rec) in zip(images, bodies):
        want = live.compress(x)
        if body != serve._encode_response(want, False):
            raise AssertionError("the served bundle's body differs from "
                                 "the live codec's strings")
        got = serve._read_pixels(io.BytesIO(rec))
        if not np.array_equal(got, live.decompress(
                want["strings"], want["shape"], u8=True)["x_hat"]):
            raise AssertionError("the served bundle's pixels differ")
    return counts["gdn_fwd"], ms, nodes


def phase_pipelines_and_bundles():
    """Phase 12: the pipelined API of the three non-AR archs, of mbt2018
    and of ssf2020, and serving bundles exported on the card. Returns the
    gdn_fwd launches of its paths (no backward kernel may run)."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.aot import load_serving_bundle

    t_phase = time.perf_counter()
    batches = _pipe_batches(PIPE_BATCHES)
    launched = 0
    live = None
    for arch in PIPE_ARCHS:
        # the decode thread on for one arch only, to keep the phase short
        codec, outs, recs, n = _pipelined_serving(
            arch, batches, ("0", "1") if arch == SERVE_ARCH else ("0",))
        launched += n
        if arch == SERVE_ARCH:
            live, live_outs, live_recs = codec, outs, recs
        else:
            del codec
    torch.cuda.empty_cache()
    t_pipe = time.perf_counter() - t_phase

    # the AR family: mbt2018 q8 through its async pair
    ar = zoo.create_model(AR_SERVE_ARCH, AR_QUALITY, seed=0, device="cuda")
    ar.update()
    x = _images(1, IMAGE)[0]
    want = ar.compress(x)
    want_rec = ar.decompress(want["strings"], want["shape"], u8=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = ar.compress_async(x)()
    t1 = time.perf_counter()
    rec = ar.decompress_async(out["strings"], out["shape"])()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    _only_fwd("mbt2018 async pair", dict(gdn.LAUNCHES), 6)
    launched += 6
    if out["strings"] != want["strings"] \
            or not np.array_equal(rec["x_hat"], want_rec["x_hat"]):
        raise AssertionError("mbt2018's async pair differs from its "
                             "synchronous calls")
    _, dev_ms, wall, _, ops = _profile(lambda: ar.decompress_async(
        out["strings"], out["shape"])(), n=1)
    log(f"async {AR_SERVE_ARCH} q{AR_QUALITY} {IMAGE[2]}x{IMAGE[1]}: "
        f"compress {1e3 * (t1 - t0):.1f} ms, decompress "
        f"{1e3 * (t2 - t1):.1f} ms (decompress device {dev_ms:.1f} ms of "
        f"{wall:.1f}, busy {100 * dev_ms / wall:.1f} %, {ops:.0f} device "
        f"operations); peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        " GiB")
    del ar

    # video: one 1080p GOP of ssf2020 through its async pair
    video = zoo.create_video_model("ssf2020", 1, seed=0, device="cuda")
    video.update()
    gop = _gops(1, VIDEO_GOP)[0]
    want_v = video.compress(gop)
    want_vrec = video.decompress(*want_v, u8=True)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out_v = video.compress_async(gop)()
    t1 = time.perf_counter()
    rec_v = video.decompress_async(*out_v)()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if any(gdn.LAUNCHES.values()):
        raise AssertionError(f"ssf2020 launched GDN kernels {gdn.LAUNCHES}")
    if out_v != want_v or not np.array_equal(rec_v, want_vrec):
        raise AssertionError("ssf2020's async pair differs from its "
                             "synchronous calls")
    _, dev_ms, wall, _, ops = _profile(
        lambda: video.compress_async(gop)(), n=1)
    log(f"async ssf2020, {VIDEO_GOP[1]} frames of {VIDEO_GOP[3]}x"
        f"{VIDEO_GOP[2]}: compress {1e3 * (t1 - t0):.1f} ms, decompress "
        f"{1e3 * (t2 - t1):.1f} ms (compress device {dev_ms:.1f} ms of "
        f"{wall:.1f}, busy {100 * dev_ms / wall:.1f} %, {ops:.0f} device "
        f"operations); 0 GDN launches; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    t_async = time.perf_counter() - t_phase - t_pipe

    # bundles exported on the card, each coding the live codec's bytes
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, k) for k in ("served", "batch",
                                                   "video")}
        exports = {
            "served": _export(live, paths["served"], IMAGE),
            "batch": _export(live, paths["batch"], PIPE_BATCH),
            "video": _export(video, paths["video"], VIDEO_GOP),
        }
        peaks = {}
        torch.cuda.reset_peak_memory_stats()
        n, served_ms, served_nodes = _serve_bundle(
            paths["served"], live, _images(BUNDLE_REQUESTS, IMAGE, seed=21))
        peaks["served"] = torch.cuda.max_memory_allocated() / 2**30
        launched += n
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        batch = load_serving_bundle(paths["batch"])
        t_load = time.perf_counter() - t0
        for k, nodes in (("served", served_nodes),
                         ("batch", _gdn_nodes(batch))):
            if set(nodes.values()) != {3}:
                raise AssertionError(f"{k} bundle's gdn_fwd nodes {nodes}")
        _reset_counts()
        b_outs, b_recs, t_b = _pipelined_loop(batch, batches[:SYNC_BATCHES])
        _only_fwd("batch bundle", dict(gdn.LAUNCHES),
                  _batch_launches(PIPE_BATCH[0]) * SYNC_BATCHES)
        launched += gdn.LAUNCHES["gdn_fwd"]
        _same_outputs("batch bundle", b_outs, b_recs, live_outs, live_recs)
        _, b_dev, b_wall, _, b_ops = _profile(
            lambda: _sync_loop(batch, batches[:1]), n=1, keep=0)
        peaks["batch"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vb = load_serving_bundle(paths["video"])
        t_vload = time.perf_counter() - t0
        _reset_counts()
        got_v = vb.compress(gop)
        got_vrec = vb.decompress(*got_v, u8=True)
        torch.cuda.synchronize()
        if any(gdn.LAUNCHES.values()):
            raise AssertionError("the video bundle launched GDN kernels")
        if got_v != want_v or not np.array_equal(got_vrec, want_vrec):
            raise AssertionError("the video bundle differs from the live "
                                 "codec")
        peaks["video"] = torch.cuda.max_memory_allocated() / 2**30
    log("bundles exported on the card (seconds, MiB): "
        + json.dumps({k: [round(t, 2), round(mb, 1)]
                      for k, (t, mb) in exports.items()})
        + f"; {SERVE_ARCH} q{QUALITY} {IMAGE[2]}x{IMAGE[1]} served by "
        f"serve.main --bundle, (/compress, /decompress) ms {served_ms}; "
        f"the {PIPE_BATCH[0]}-image bundle loaded in {t_load:.1f} s, "
        f"{PIPE_BATCH[0] * SYNC_BATCHES / t_b:.2f} images/s pipelined, "
        f"a synchronous batch {b_wall:.1f} ms, device {b_dev:.1f} ms (busy "
        f"{100 * b_dev / b_wall:.1f} %, {b_ops:.0f} device operations); "
        f"the video bundle loaded in {t_vload:.1f} s; peak GiB of each "
        "bundle's leg (the live codecs still held) "
        + json.dumps({k: round(v, 2) for k, v in peaks.items()})
        + "; every bundle's strings and pixels equal the live codec's; 3 "
        "gdn_fwd nodes in _analyze_u8__one and in each _synth_u8 variant")
    del live, video, batch, vb
    torch.cuda.empty_cache()
    log(f"pipelines and bundles phase: {time.perf_counter() - t_phase:.1f}"
        f" s (pipelined serving {t_pipe:.1f}, async pairs {t_async:.1f}); "
        f"{launched} gdn_fwd launches, no backward")
    return launched


def _from_torch(path, arch, quality, out_dir, *flags):
    """`update_model_cli.run` on a CompressAI-format file, on the card."""
    from lmic_tpu_torch.utils import update_model_cli

    return update_model_cli.run([path, "-a", arch, "-q", str(quality),
                                 "-d", out_dir, "--from-torch", *flags])


def _serve_checkpoint(path, arch, quality, payloads):
    """`serve.main --checkpoint path` in a thread: each payload through
    POST /compress and /decompress, the launch counts set to 0 just
    before and read just after. Returns ([(body, rec, compress ms,
    decompress ms)], launch counts)."""
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils import serve

    started, ready = [], threading.Event()
    thread = threading.Thread(
        target=serve.main,
        args=(["--checkpoint", path, "-a", arch, "-q", str(quality),
               "--port", "0"],),
        kwargs={"started": lambda srv: (started.append(srv), ready.set())},
        daemon=True)
    thread.start()
    if not ready.wait(300):
        raise AssertionError(f"the {arch} server did not start")
    server = started[0]
    port = server.server_address[1]
    try:
        _post(port, "/decompress", _post(port, "/compress", payloads[0]))
        _reset_counts()
        out = []
        for payload in payloads:
            t0 = time.perf_counter()
            body = _post(port, "/compress", payload)
            t1 = time.perf_counter()
            rec = _post(port, "/decompress", body)
            out.append((body, rec, 1e3 * (t1 - t0),
                        1e3 * (time.perf_counter() - t1)))
        counts = dict(gdn.LAUNCHES)
    finally:
        server.shutdown()
        thread.join(60)
    if thread.is_alive():
        raise AssertionError(f"the {arch} server did not stop")
    return out, counts


def _pretrained_image(tmp):
    """A CompressAI-format file of mbt2018-mean q8 from seed 0 with its
    baked tables -> `update_model_cli --from-torch` -> `serve.main
    --checkpoint` (three 512x768 requests); then `--no-update` and
    `--raw-params` on the same file against the plain finalization.
    Returns the served requests' `gdn_fwd` launches."""
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils import serve
    from lmic_tpu_torch.utils.checkpoint import update_model_file
    from lmic_tpu_torch.utils.codec_cli import read_body
    from lmic_tpu_torch.utils.crosscheck import (
        reference_table_mismatches,
        write_reference_checkpoint,
    )

    arch, q = PRETRAINED_ARCH, PRETRAINED_QUALITY
    t0 = time.perf_counter()
    source = zoo.create_model(arch, q, seed=0, device="cuda")
    source.update()
    path = os.path.join(tmp, f"{arch}-{q}.pth.tar")
    sd = write_reference_checkpoint(path, source)
    final = _from_torch(path, arch, q, os.path.join(tmp, "final"))
    direct, _ = serve.load_checkpoint_codec(final, arch, q)
    bad = reference_table_mismatches(direct, sd)
    if bad:
        raise AssertionError(f"{arch}: finalized tables differ from the "
                             f"file's buffers: {bad}")
    t_final = time.perf_counter() - t0
    images = _images(PRETRAINED_REQUESTS, seed=21)
    payloads = []
    for x in images:
        buf = io.BytesIO()
        serve._write_pixels(buf, x)
        payloads.append(buf.getvalue())
    requests, counts = _serve_checkpoint(final, arch, q, payloads)
    _only_fwd("served --from-torch checkpoint", counts,
              6 * len(images))  # 3 GDN in g_a + 3 IGDN in g_s a round trip
    for i, (x, (body, rec, c_ms, d_ms)) in enumerate(zip(images, requests)):
        shape, groups = read_body(io.BytesIO(body))
        out = direct.compress(x)
        if [list(g) for g in out["strings"]] != groups \
                or tuple(out["shape"]) != tuple(shape) \
                or direct.compress(x)["strings"] != out["strings"]:
            raise AssertionError("the served body differs from the direct "
                                 "call, or encoding is not deterministic")
        if source.compress(x)["strings"] != out["strings"]:
            raise AssertionError("the finalized codec codes other strings "
                                 "than the file's source")
        got = serve._read_pixels(io.BytesIO(rec))
        want = direct.decompress(out["strings"], out["shape"], u8=True)
        if got.shape != x.shape or not np.array_equal(got, want["x_hat"]):
            raise AssertionError("/decompress differs from the direct call")
        if i == 0:
            _roundtrip_checks(direct, x, out["strings"], out["shape"])
        nbytes = sum(len(s) for g in groups for s in g)
        log(f"pretrained request {i}: {nbytes} bytes "
            f"({8 * nbytes / (x.shape[1] * x.shape[2]):.4f} bpp), "
            f"/compress {c_ms:.1f} ms, /decompress {d_ms:.1f} ms")
    # --no-update then --raw-params: the plain finalization of the weights
    t1 = time.perf_counter()
    bare = _from_torch(path, arch, q, os.path.join(tmp, "bare"),
                       "--no-update")
    from lmic_tpu_torch.utils import update_model_cli

    raw = update_model_cli.run([bare, "-a", arch, "-q", str(q), "-d",
                                os.path.join(tmp, "raw"), "--raw-params"])
    plain = update_model_file(os.path.join(tmp, "plain"), source,
                              f"{arch}-q{q}")
    with open(raw, "rb") as a, open(plain, "rb") as b:
        if a.read() != b.read():
            raise AssertionError("--no-update + --raw-params differs from "
                                 "the plain finalization")
    log(f"{arch} q{q} (N={source.module.N}, M={source.module.M}): a "
        f"CompressAI-format file written, finalized --from-torch as "
        f"{os.path.basename(final)} and loaded in {t_final:.1f} s; tables "
        f"equal to the file's buffers; three requests served with "
        f"{counts['gdn_fwd']} gdn_fwd; --no-update + --raw-params = the "
        f"plain finalization {os.path.basename(plain)} "
        f"({time.perf_counter() - t1:.1f} s)")
    return counts["gdn_fwd"]


def _pretrained_video(tmp):
    """ssf2020 from seed 0 as a CompressAI-format file with the three
    sub-codecs' baked tables, finalized --from-torch; one 1920x1152 GOP
    coded to the source's strings, decoded to the encoder's in-loop
    frames, with no GDN launch."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils import checkpoint as ckpt
    from lmic_tpu_torch.utils.crosscheck import (
        reference_table_mismatches,
        write_reference_checkpoint,
    )

    t0 = time.perf_counter()
    source = zoo.create_video_model("ssf2020", 1, seed=0, device="cuda")
    source.update()
    path = os.path.join(tmp, "ssf2020-1.pth.tar")
    sd = write_reference_checkpoint(path, source)
    final = ckpt.load_updated_model(
        _from_torch(path, "ssf2020", 1, os.path.join(tmp, "video")),
        zoo.create_video_model("ssf2020", 1, seed=3, device="cuda"))
    bad = reference_table_mismatches(final, sd)
    if bad:
        raise AssertionError(f"ssf2020: finalized tables differ: {bad}")
    gop = _gops(1)[0]
    out, counts, ms = _counted(final.compress, gop)
    _only_fwd("ssf2020 --from-torch GOP", counts, 0)
    if out != source.compress(gop):
        raise AssertionError("ssf2020: the finalized codec codes other "
                             "strings than the file's source")
    with torch.inference_mode():
        _, recs = final._encode_gop(final._frames(gop))
        in_loop = torch.stack(recs, 1).permute(0, 1, 3, 4, 2).cpu()
    if not np.array_equal(final.decompress(*out), in_loop.numpy()):
        raise AssertionError("ssf2020: the decoder's frames differ from "
                             "the encoder's in-loop reconstructions")
    key, inter = _gop_bytes(out[0])
    log(f"ssf2020 from a CompressAI-format file: finalized, loaded and one "
        f"3-frame 1920x1152 GOP coded ({ms:.1f} ms; keyframe {key} bytes, "
        f"inter {inter}) and decoded in {time.perf_counter() - t0:.1f} s; "
        "tables equal to the file's buffers, strings equal to the "
        "source's, 0 GDN launches")
    del source, final


class RecomputePeaks:
    """Within the block: the peak memory of each span of the backward
    from one recompute of a `remat` block to the next, under the block's
    name (`forward` for the forward and the backward up to the first
    recompute)."""

    def __init__(self, module):
        self.names = {id(m): n for n, m in module.named_modules()}
        self.peaks = {}

    def _label(self, fn, args):
        from torch import nn

        from lmic_tpu_torch.layers import remat

        mods = list(args[0]) if fn is remat._through else [
            a for a in args if isinstance(a, nn.Module)]
        owner = getattr(fn, "__self__", None)
        head = "" if owner is None else self.names.get(
            id(owner), type(owner).__name__) + "."
        return (head + fn.__name__ + "("
                + ",".join(self.names.get(id(m), type(m).__name__)
                           for m in mods) + ")")

    def _close(self):
        import torch

        peak = torch.cuda.max_memory_allocated()
        self.peaks[self.current] = max(self.peaks.get(self.current, 0), peak)
        torch.cuda.reset_peak_memory_stats()

    def __enter__(self):
        import torch

        from lmic_tpu_torch.layers import remat

        self.inside = remat._inside

        def inside(fn, *args):
            if torch._C._current_graph_task_id() != -1:  # a recompute
                self._close()
                self.current = self._label(fn, args)
            return self.inside(fn, *args)

        remat._inside = inside
        torch.cuda.reset_peak_memory_stats()
        self.current = "forward"
        return self

    def __exit__(self, *exc):
        from lmic_tpu_torch.layers import remat

        self._close()
        remat._inside = self.inside

    def top(self, n=4):
        return {k: round(v / 2**30, 2) for k, v in sorted(
            self.peaks.items(), key=lambda kv: -kv[1])[:n]}


def _remat_steps():
    """mbt2018-mean q7 at batch 16 of 256x256 under --remat, f32 and AMP:
    timed steps with exact launch counts (REMAT_STEP a step), and one step
    against the plain step with the same noise (`fixed_noise`). Returns
    the launch counts of the timed steps."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.crosscheck import remat_step_agreement
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    batch = _train_batch(TRAIN_BATCH, seed=1)
    counts = {k: 0 for k in gdn.LAUNCHES}
    for mode, dtype in (("f32", None), ("amp", torch.bfloat16)):
        module = zoo.create_model(TRAIN_ARCH, TRAIN_QUALITY, seed=0,
                                  device="cuda", dtype=dtype).module
        opt = make_optimizer()
        state = create_train_state(module, opt)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = make_train_step(module, opt, TRAIN_LAMBDA, remat=True)
        launched = _train_case(
            f"{TRAIN_ARCH} q{TRAIN_QUALITY} {mode} --remat batch "
            f"{TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}x{TRAIN_BATCH[2]}",
            step, state, (batch,), gen, 4, REMAT_STEP)
        for k, v in launched.items():
            counts[k] += v
        with RecomputePeaks(module) as spans:  # an uncounted step
            step(state, batch, gen)
        log(f"{mode} --remat step: highest backward spans (GiB) "
            + json.dumps(spans.top()))
        del module, state, opt, step
        t0 = time.perf_counter()
        loss_err, grad_err, once = remat_step_agreement(
            TRAIN_ARCH, TRAIN_QUALITY, batch, TRAIN_LAMBDA, dtype=dtype)
        loss_bar, grad_bar = REMAT_BARS[mode]
        if once != REMAT_STEP or not (loss_err <= loss_bar
                                      and grad_err <= grad_bar):
            raise AssertionError(
                f"{mode} --remat step against the plain step: launches "
                f"{once}, loss {loss_err:.3g}, gradients {grad_err:.3g}")
        log(f"{mode} --remat step against the plain step (same noise): "
            f"losses within {loss_err:.3g}, clipped gradients within "
            f"{grad_err:.3g} ({time.perf_counter() - t0:.1f} s)")
        torch.cuda.empty_cache()
    return counts


def _remat_master():
    """The channel-1 master q7 against its frozen guide under --remat at
    REMAT_MASTER_BATCH: a warm-up step and a timed one, launch counts set
    to 0 just before and read just after (18 `gdn_fwd`, 6 of each backward
    kernel a step), step ms and peak memory. Returns the counts."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        expandable_segments,
        make_optimizer,
    )
    from lmic_tpu_torch.utils.train_cli import make_master_train_step

    torch.cuda.empty_cache()
    expandable_segments("cuda")  # as train_cli --remat runs
    q, B = RGBT_QUALITY, REMAT_MASTER_BATCH
    guided = zoo.create_model("guided", q, seed=0, channel=3,
                              first_stride=2, device="cuda").module
    guided.eval().requires_grad_(False)
    master = zoo.create_model("master", q, seed=1, channel=1,
                              device="cuda").module
    opt = make_optimizer()
    state = create_train_state(master, opt)
    step = make_master_train_step(master, guided, opt, LAMBDAS[q - 1],
                                  remat=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    xm = _train_batch((B, *MASTER_BATCH[1:]), seed=3)
    xg = _train_batch((B, *MASTER_GUIDE[1:]), seed=4)
    t0 = time.perf_counter()
    _, first = step(state, xm, xg, gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    with RecomputePeaks(master) as spans:
        _, second = step(state, xm, xg, gen)
        torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launched = dict(gdn.LAUNCHES)
    peak = max(spans.peaks.values())
    want = {k: 18 if k == "gdn_fwd" else 6 for k in launched}
    losses = [float(first["loss"]), float(second["loss"])]
    if launched != want or not all(np.isfinite(losses)):
        raise AssertionError(f"master --remat batch {B}: launches "
                             f"{launched}, losses {losses}")
    log(f"train master q{q} (N={master.N}, M={master.M}) channel 1 f32 "
        f"--remat batch {B} of {MASTER_BATCH[1]}x{MASTER_BATCH[2]} with "
        f"{MASTER_GUIDE[1]}x{MASTER_GUIDE[2]} guides: step {ms:.1f} ms, "
        f"peak memory {peak / 2**30:.2f} GiB, loss {losses[0]:.3f} -> "
        f"{losses[1]:.3f}; built and a warm-up step {t_warm:.1f} s; "
        f"highest backward spans (GiB) {json.dumps(spans.top())}")
    del guided, master, state, opt, xm, xg
    torch.cuda.empty_cache()
    return launched


def phase_pretrained_and_remat():
    """Phase 13 (see the module doc): a CompressAI-format file finalized --from-torch and
    served (mbt2018-mean q8, and an ssf2020 GOP), then training under
    --remat (mbt2018-mean q7 f32 and AMP, the master at batch 16). Returns
    (the served requests' `gdn_fwd` launches, the training steps' launch
    counts)."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        served = _pretrained_image(tmp)
        _pretrained_video(tmp)
    t_pre = time.perf_counter() - t_phase
    counts = _remat_steps()
    for k, v in _remat_master().items():
        counts[k] += v
    log(f"pretrained and remat phase: {time.perf_counter() - t_phase:.1f} s "
        f"(pretrained {t_pre:.1f} s)")
    return served, counts


def _totals(cases, kernel, rows, dtype, C=192):
    """Sums over one main-path pass (a round trip or a training step): the
    GDN and the IGDN at each of `rows`, at width C; `rows` may map each
    count to the times the pass runs it in each direction, or to a pair
    (GDN times, IGDN times)."""
    times = rows if isinstance(rows, dict) else dict.fromkeys(rows, 1)
    sel = [c for c in cases[kernel] if c["shape"][0] in times
           and c["shape"][1] == C and c["dtype"] == dtype]
    if len(sel) != 2 * len(times):
        raise AssertionError(f"{len(sel)} {kernel} main-path cases")

    def n(c):
        t = times[c["shape"][0]]
        return t[c["inverse"]] if isinstance(t, tuple) else t

    def total(key):
        return sum(c[key] * n(c) for c in sel) / 1e3

    t = {k: total(k) for k in ("us", "plain_us", "bound_us", "bytes_us",
                               "operations_us", "library_us")}
    return {"ms": t["us"], "plain_ms": t["plain_us"],
            "bound_ms": t["bound_us"],
            "bound_by": ("operations" if t["operations_us"] >= t["bytes_us"]
                         else "bytes"),
            "library_ms": t["library_us"]}


def _max_abs_err_by_dtype(kcases):
    """max |kernel - plain| over the cases of each dtype."""
    by = {}
    for c in kcases:
        by[c["dtype"]] = max(by.get(c["dtype"], 0.0), c["max_abs_err"])
    return by


def main():
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="run the environment and kernel phases only "
                             "and print no result")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import lmic_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(lmic_tpu_torch.__file__)) != ROOT:
        print("chip_smoke: lmic_tpu_torch was imported from elsewhere",
              file=sys.stderr)
        return 2
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils.determinism import set_wire_determinism

    set_wire_determinism()
    t_start = time.perf_counter()
    smi = phase_environment()
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    cases = phase_kernel(_peaks(name))
    log(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    for kernel, kcases in cases.items():
        for c in kcases:
            log(f"{kernel} {c['shape']} {c['dtype']} inverse={c['inverse']}: "
                f"{c['us']:.1f} us (plain {c['plain_us']:.1f}, library "
                f"{c['library_us']:.1f}, bound {c['bound_us']:.1f} by "
                f"{c['bound_by']}), rel err {c['max_rel_err']:.2e}, abs err "
                f"{c['max_abs_err']:.3g}")
    if args.kernels_only:
        log(json.dumps({"kernels_only": {
            kernel: {f"training_step_{d}": _totals(cases, kernel,
                                                   TRAIN_ROWS[:3], d)
                     for d in ("float32", "bfloat16")}
            for kernel in cases}}))
        return 0
    t0 = time.perf_counter()
    serve_launches = phase_serving()
    phase_other_archs()
    log(f"serving phases: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_counts, train_steps = phase_training()
    log(f"training phase: {time.perf_counter() - t0:.1f} s")
    ar_launches, _ = phase_ar_serving()
    rgbt_launches = phase_rgbt_serving()
    more_training = phase_ar_rgbt_training()
    paired_launches, more_training["paired_training"] = phase_paired()
    video_launches = phase_video_serving()
    eval_launches = phase_eval_and_files()
    pipe_launches = phase_pipelines_and_bundles()
    pretrained_launches, more_training["remat_training"] = \
        phase_pretrained_and_remat()

    def totals(kernel, rows, dtype, C=192):
        return _totals(cases, kernel, rows, dtype, C)

    errors = {k: _max_abs_err_by_dtype(v) for k, v in cases.items()}
    # every training path: mbt2018-mean (phase 5), the AR family and the
    # RGB-T pair (phase 8), the paired `_R` arch (phase 9), --remat
    # (phase 13)
    training = {"training": train_counts, **more_training}
    launched = {k: sum(c[k] for c in training.values()) for k in gdn.LAUNCHES}
    bwd_counts = {k: launched[k] for k in gdn.BWD_KERNELS}
    if len(set(bwd_counts.values())) != 1:
        raise AssertionError(f"backward kernels launched {bwd_counts}")
    kernels = [{
        "name": "gdn_fwd",
        "route": "cuda",
        "source": "lmic_tpu_torch/csrc/gdn_fwd.cu",
        "replaces": "lmic_tpu/ops/pallas_gdn.py:71",
        "launches": (serve_launches + ar_launches + rgbt_launches
                     + paired_launches + eval_launches + pipe_launches
                     + pretrained_launches + launched["gdn_fwd"]),
        "launches_by_path": {"serving": serve_launches,
                             "ar_serving": ar_launches,
                             "rgbt_serving": rgbt_launches,
                             "paired_serving": paired_launches,
                             "video_serving": video_launches,
                             "eval_and_files": eval_launches,
                             "pipelines_and_bundles": pipe_launches,
                             "pretrained_serving": pretrained_launches,
                             **{p: c["gdn_fwd"]
                                for p, c in training.items()}},
        "launches_per_step": train_counts["gdn_fwd"] / train_steps,
        "max_abs_err": max(errors["gdn_fwd"].values()),
        "max_abs_err_by_dtype": errors["gdn_fwd"],
        # one q8 512x768 round trip: 3 GDN in g_a, 3 IGDN in g_s, f32
        **totals("gdn_fwd", SERVE_ROWS[:3], "float32"),
        # the same at C = 128 (cheng2020-anchor q3)
        "round_trip_c128": totals("gdn_fwd", SERVE_ROWS[:3], "float32",
                                  128),
        # one RGB-T round trip (channel 1, 512x640 + 1024x1280, guide
        # cached on the decompress leg): 12 launches, 1,075,200 rows
        "round_trip_rgbt": totals("gdn_fwd", RGBT_ROUND_TRIP, "float32"),
        # one paired round trip (an `_R` -> `_D` pair at 512x640): 15
        # launches, 9 GDN and 6 IGDN
        "round_trip_paired": totals("gdn_fwd", PAIRED_ROUND_TRIP,
                                    "float32"),
        "training_step_f32": totals("gdn_fwd", TRAIN_ROWS[:3], "float32"),
        "training_step_bf16": totals("gdn_fwd", TRAIN_ROWS[:3], "bfloat16"),
        # a --remat step: each GDN and IGDN again in its block's recompute
        "training_step_remat_f32": totals("gdn_fwd", REMAT_ROWS, "float32"),
        "training_step_remat_bf16": totals("gdn_fwd", REMAT_ROWS,
                                           "bfloat16"),
        # the master's step (batch 4): 12 launches, the frozen guide's six
        # at 1,310,720 / 327,680 / 81,920 rows and the master's six
        "training_step_master": totals("gdn_fwd", MASTER_STEP_FWD,
                                       "float32"),
        # one batch of phase 12's pipelined loop (16 of 768x512): 51
        # launches, 48 GDN per image and 3 batched IGDN
        "pipelined_batch": totals("gdn_fwd", PIPE_BATCH_FWD, "float32"),
        "card": smi,
    }, {
        "name": "gdn_bwd",
        "route": "cuda",
        "source": "lmic_tpu_torch/csrc/gdn_bwd.cu",
        "replaces": "lmic_tpu/ops/pallas_gdn.py:195",
        "launches": next(iter(bwd_counts.values())),
        "launches_by_kernel": bwd_counts,
        "launches_by_path": {"video_serving": video_launches,
                             "eval_and_files": 0,
                             "pipelines_and_bundles": 0,
                             "pretrained_serving": 0,
                             **{p: c[gdn.BWD_KERNELS[0]]
                                for p, c in training.items()}},
        "launches_per_step": train_counts[gdn.BWD_KERNELS[0]] / train_steps,
        "max_abs_err": max(errors["gdn_bwd"].values()),
        "max_abs_err_by_dtype": errors["gdn_bwd"],
        # one f32 training step: 6 calls of the three kernels each
        **totals("gdn_bwd", TRAIN_ROWS[:3], "float32"),
        "training_step_bf16": totals("gdn_bwd", TRAIN_ROWS[:3], "bfloat16"),
        # the master's step (batch 4 of 512x640): 327,680 / 81,920 / 20,480
        "training_step_master": totals("gdn_bwd", MASTER_STEP_ROWS,
                                       "float32"),
        "card": smi,
    }] + [{
        # gdn_bwd's three launches, each timed on its own
        "name": name,
        "route": "cuda",
        "source": "lmic_tpu_torch/csrc/gdn_bwd.cu",
        "replaces": "lmic_tpu/ops/pallas_gdn.py:195",
        "launches": launched[name],
        "launches_per_step": train_counts[name] / train_steps,
        "max_abs_err": max(errors[name].values()),
        "max_abs_err_by_dtype": errors[name],
        **totals(name, TRAIN_ROWS[:3], "float32"),
        "training_step_bf16": totals(name, TRAIN_ROWS[:3], "bfloat16"),
        "training_step_master": totals(name, MASTER_STEP_ROWS, "float32"),
        "card": smi,
    } for name in gdn.BWD_KERNELS]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
