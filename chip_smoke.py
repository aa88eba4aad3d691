#!/usr/bin/env python3
"""On-card smoke run of lmic_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py                 # from the root of a checkout, one GPU
    python3 chip_smoke.py --kernels-only  # phases 1 and 2 alone, no result

Phases, each of which raises (exit code != 0) on any failure:

1. environment: the card's name and power limit, the torch/CUDA/nvcc
   versions; the port's native sources are built, all at once; each GDN
   kernel's registers and spills from ptxas (a register-tiled f32 kernel
   and the bf16 `gdn_fwd_wide_kernel` and `gdn_bwd_dx_wide_kernel` must
   not spill); the count of
   tensor-core instructions (HMMA or HGMMA) in each GDN kernel, from
   `cuobjdump -sass`: every bf16 product kernel must have some (the
   TMA-fed wide kernels HGMMA, from wgmma), and no f32 kernel any (that
   would be TF32);
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
   of the partials), each dx launch and each bf16 `gdn_fwd` held to the
   kernel its route names (f32 `gdn_bwd_dx_kernel`; bf16
   `gdn_bwd_dx_wide_kernel` and `gdn_fwd_wide_kernel` at these shapes,
   and `gdn_bwd_dx_mma_kernel` and `gdn_fwd_mma_kernel`, each against its
   plain version, at two bf16 shapes off the TMA route, 16,391 rows at
   C = 192 in a view offset by one element and at C = 320); bf16
   `gdn_fwd` and `gdn_bwd_dx` logged per layer of a training step
   (C = 192 and 128) beside their bounds and composites;
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
   profile of the GDN kernels' share (in AMP, 6 launches a step of
   `gdn_fwd_wide_kernel` and of `gdn_bwd_dx_wide_kernel`, and none of
   `gdn_fwd_mma_kernel` or `gdn_bwd_dx_mma_kernel`), one
   step's gradients on the card
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
   in its block's recompute; the AMP step's profile 12 launches of
   `gdn_fwd_wide_kernel`, 6 of `gdn_bwd_dx_wide_kernel` and none of the
   mma kernels), the loss falling, step ms and peak memory
   logged, and one step against the plain step under
   `crosscheck.fixed_noise` (losses and clipped gradients within the f32
   and bf16 bars, exact launch counts); then the channel-1 master q7
   under --remat against its frozen guide at lmic_tpu's batch of 16, with
   the caching allocator's expandable segments as `train_cli --remat`
   sets them (two steps, 18 `gdn_fwd` and 6 of each backward kernel the
   timed one; step ms, peak memory and the backward spans, from one
   block's recompute to the next, with the highest memory logged);
14. matmul precision, last: lmic_tpu's bf16 matmul precision
   (`ops/precision.py`). `eval_model --half`'s cores
   (`eval_image_codec`, `eval_image_forward`, `eval_rgbt_pair`) under the
   mode on three seeded 512x768 images for mbt2018-mean q8 and
   cheng2020-anchor q3 (wavefront) and on the channel-1 RGB-T pair q7
   (a 512x640 master, a 1024x1280 guide), the counts set to 0 just
   before and read just after: 6 f32 `gdn_fwd_kernel` launches a round
   trip and an estimate, 12 a pair, no other GDN kernel (the C ABI's
   exact counts; lmic_tpu keeps the GDN at HIGHEST); each `--half`
   stream other than the f32 one of the same codec, decoding to its
   encoder's latents; the tables untouched and the f32 strings again
   after the mode; the card within 2e-2 of the CPU under the mode (the
   CPU tests' bar; transforms, wavefront steps, the pair stage by
   stage); rounded calls, encode and decode ms in f32 and under the
   mode, a round trip's device ms, busy share and conv/GEMM engines
   logged. Then mbt2018-mean q7 at batch 16 of 256x256 in f32, AMP,
   `--bf16` and `--bf16 --remat` in one process (a warm-up, a profiled
   and 4 timed steps each; under --bf16 6 f32 `gdn_fwd_kernel` a step,
   12 with --remat, 6 of each f32 backward kernel, no bf16 GDN kernel),
   each step's ms, device ms, busy share and peak memory logged, and one
   narrow --bf16 step on the card against the CPU with the same noise
   (losses within 1e-3, the clipped gradients as one vector within a
   quarter of the rounding's own effect, the CPU's --bf16 step against
   its f32 step).
15. data parallelism, last (`lmic_tpu_torch/parallel/`): phase 5's step
   (mbt2018-mean q7, batch 16 of 256x256), f32 and AMP, each mode in
   process groups of its own: two steps under DistributedDataParallel in
   a one-rank NCCL group in this process, bit for bit the plain steps
   (metrics, gradients, parameters), with both steps' ms; then two ranks
   spawned on the one card under gloo (NCCL refuses two ranks on one
   GPU), 8 rows each of the same global batch and the rows of the same
   noise (`crosscheck.fixed_noise`), held to the one-rank step on the
   whole 16: losses within lmic_tpu's 2e-5, the all-reduced gradient as
   one vector within 1e-5 in f32 and two bf16 roundings in AMP, the
   ranks' parameters bit-equal after each step, 6 launches of each GDN
   kernel a step per rank by the C ABI (AMP on the wide kernels); each
   rank's step ms, device ms and the all-reduce's share of it, and peak
   memory logged. Then `shard_codec` over a two-slot mesh [cuda:0,
   cuda:0]: mbt2018-mean q8 on four 512x768 images (18 `gdn_fwd` a round
   trip: 12 per image, 6 for the synthesis's two row blocks), mbt2018 q8
   on two (a thread a slot; 9) and ssf2020 on two 3-frame 512x768
   sequences (0), strings byte-identical to the one-slot codec's,
   images/s both ways; a bundle exported from the sharded mbt2018-mean
   codec served over the two-slot mesh with its strings, a mesh of three
   refused; `check_homogeneous([cuda:0, cpu])` refused; and, logged and
   not held, mbt2018-mean q8 coded on the card and decoded on the CPU and
   the reverse (ROADMAP C).
16. apps and ablation, last: phase 3's round trip (mbt2018-mean q8,
   three 512x768 images, direct calls) inside `utils/profiling.py`'s
   `device_trace` and `annotate`, each leg in a `Timings` section and the
   encode through `timed`: exactly 18 `gdn_fwd` launches by the C ABI, a
   Chrome trace holding the annotation and at least one GDN kernel record
   (their count logged, not held: records can be lost), and each
   section's wall ms at least the CUDA-event device ms of its work. Then
   phase 5's step (mbt2018-mean q7, batch 16 of 256x256) in f32 and AMP,
   10 steps timed on the host clock and by CUDA events and 3 profiled,
   with `LMIC_ABLATE_GDN` unset and then set in the process (unset again
   in a `finally`): 6 `gdn_fwd` and 6 of each backward launch a plain
   step, 0 of every GDN kernel an ablated one, by the wrappers and the C
   ABI; the device's busy ms (the profile's kernel sum), the event span,
   wall ms and peak memory of the four cases and GDN's share logged; one
   round trip after it launches 6 again. Then the apps' device work on
   the card against the CPU: `video_bench._sequence_metrics` on a 3-frame 1920x1080 YUV420 pair
   (psnr within 1e-4 dB, ms-ssim within 1e-5; ms a frame logged),
   `bench_codecs._metrics_vs` on a 768x512 pair at the same bars, and
   `layers.GDN1` forward, inverse and backward at C = 192 on 65,536 rows
   within 1e-5; `X264().availability_error()` logged. No PIL or msgpack
   path runs (the card's machine may lack both).

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
# phase 14, lmic_tpu's bf16 matmul precision (`eval_model --half`,
# `train_cli --bf16`; ops/precision.py)
HALF_CODECS = (("mbt2018-mean", 8), ("cheng2020-anchor", 3))
HALF_IMAGES = 3
# the CPU tests' bar under the mode (tests/test_torch_precision.py): of
# each tensor's largest value
HALF_BAR = 2e-2
# the bf16 mode's narrow step on the card against the CPU's: the losses
# within the card's bf16 bar of the training phases, the clipped
# gradients as one vector within a quarter of the rounding's own effect
# there (the CPU's bf16 step against its f32 step; the CPU tests' pooled
# bar). Single leaves of h_a and h_s move by up to a sixth: summation
# order moves an f32 sum by an ulp and flipped bf16 roundings follow, with
# the rounded operands in FP32 as in TF32 (`chip_probes.py bf16-step`)
BF16_STEP_BARS = (1e-3, 0.25)

# phase 15, data parallelism (lmic_tpu_torch/parallel/): phase 5's step
# (mbt2018-mean q7, batch 16 of 256x256), checked over DP_STEPS steps in
# a one-rank NCCL group (bit for bit the plain step) and on two gloo
# ranks on the one card (8 rows each) against the one-rank step on the
# whole batch, then DP_TIMED steps per rank, the last profiled; lmic_tpu's
# bar for its sharded step on the losses (tests/test_train.py:126), and
# on the all-reduced gradient as one vector 1e-5 in f32; in AMP each
# rank's weight gradients come out of their bf16 convs rounded to bf16
# before the all-reduce (the whole batch's once, after its sum), so the
# gradient is held to two bf16 roundings, 2 * 2^-9
DP_STEPS, DP_TIMED = 2, 3
DP_LOSS_RTOL = 2e-5
DP_GRAD_RTOL = {"f32": 1e-5, "amp": 2.0 ** -8}
# the fan-out over a two-slot mesh on the one card: mbt2018-mean q8 on
# four 512x768 images, mbt2018 q8 on two, ssf2020 on two 3-frame
# sequences at 512x768 (cut from phase 10's 1920x1152 for time)
FAN_IMAGES, FAN_AR_IMAGES = 4, 2
FAN_GOPS = (2, 3, 512, 768, 3)

# phase 16, apps and ablation: phase 3's round trip of APPS_IMAGES images
# profiled through utils/profiling.py (the annotation below names it in
# the trace); phase 5's step, ABLATION_TIMED steps each with and without
# LMIC_ABLATE_GDN, in f32 and AMP; the apps' device work on the card
# against the CPU at the CPU tests' bars: video_bench's sequence metrics
# on a 3-frame 1080p YUV420 pair, bench_codecs' metrics on a 768x512
# pair, GDN1 at C = 192 on GDN1_ROWS rows
APPS_IMAGES = 3
APPS_ANNOTATION = "apps_round_trip"
ABLATION_TIMED = 10
APPS_CLIP = (3, 1080, 1920)  # frames, H, W
APPS_ARRAY = (512, 768, 3)
GDN1_ROWS, GDN1_C = 65_536, 192
APPS_BARS = {"psnr": 1e-4, "ms-ssim": 1e-5, "gdn1": 1e-5}


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
# cores (those fed by the TMA on wgmma: HGMMA); the f32 kernels (TF32 off)
# and the reduce must not.
MMA_KERNELS = ("gdn_fwd_mma_kernel", "gdn_fwd_wide_kernel",
               "gdn_bwd_dx_mma_kernel", "gdn_bwd_dx_wide_kernel",
               "gdn_bwd_partials_wide_kernel")
WGMMA_KERNELS = ("gdn_fwd_wide_kernel", "gdn_bwd_dx_wide_kernel",
                 "gdn_bwd_partials_wide_kernel")
FP32_KERNELS = ("gdn_fwd_kernel", "gdn_bwd_dx_kernel",
                "gdn_bwd_partials_kernel", "gdn_bwd_reduce_kernel")
# launches of each CUDA kernel a step under --bf16 (the GDN stays f32:
# HIGHEST in lmic_tpu) and under --bf16 --remat
BF16_STEP = {**{k: 0 for k in MMA_KERNELS},
             **{k: 6 for k in FP32_KERNELS}}
BF16_REMAT_STEP = {**BF16_STEP, "gdn_fwd_kernel": 12}


# The register-tiled f32 kernels (8 x 4 accumulators a thread): the two on
# the shared loop of csrc/gdn_f32.cuh and the partials. Their accumulators
# must stay in registers.
TILED_FP32_KERNELS = ("gdn_fwd_kernel", "gdn_bwd_dx_kernel",
                      "gdn_bwd_partials_kernel")
# ... and so must the bf16 wide kernels' (wgmma sums; dn, g * scale)
NO_SPILL_KERNELS = TILED_FP32_KERNELS + ("gdn_fwd_wide_kernel",
                                         "gdn_bwd_dx_wide_kernel")


def _check_registers(source, log_path):
    """Log each kernel's registers and spills from the build's ptxas
    output (-Xptxas -v); raise if a register-tiled f32 kernel or the bf16
    wide dx kernel spills, or is missing from the report."""
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
        if kernel.startswith(NO_SPILL_KERNELS) and any(
                info.get("spill", (1, 1))):
            raise AssertionError(f"{kernel} spills: {info}")
    for name in NO_SPILL_KERNELS:
        if name.startswith(source[:-3] + "_") and not any(
                k.startswith(name) for k in seen):
            raise AssertionError(f"no ptxas report of {name} in {log_path}")


def _check_tensor_cores(source, lib):
    """Count tensor-core instructions (HMMA from mma.sync and wmma, HGMMA
    from wgmma) per kernel in `lib` (cuobjdump -sass); raise if a bf16
    product kernel has none, a wgmma kernel has no HGMMA, or another GDN
    kernel has one."""
    from lmic_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    # kernel name -> [HMMA, HGMMA] counts of each instantiation
    counts = {}
    current = None
    for line in sass.splitlines():
        # letters and underscores only: the anonymous namespace's mangled
        # name (gdn_fwd_cu_<hash>) comes first on the line
        m = re.search(r"Function : \S*?(gdn_[a-z_]+?_kernel)", line)
        if m:
            current = counts.setdefault(m.group(1), [])
            current.append([0, 0])
        elif current is not None:
            m = re.search(r"\b(HG?MMA)\b", line)
            if m:
                current[-1][m.group(1) == "HGMMA"] += 1
    log(f"HMMA/HGMMA instructions in {source}: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    for name, found in counts.items():
        if name in MMA_KERNELS and not all(sum(f) for f in found):
            raise AssertionError(f"{name} has no tensor-core instruction")
        if name in WGMMA_KERNELS and not all(f[1] for f in found):
            raise AssertionError(f"{name} has no HGMMA (wgmma) instruction")
        if name not in MMA_KERNELS and any(sum(f) for f in found):
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
    dn, dn_sums = gdn._dn_scratch(lib, n, C, x.dtype, "cuda")
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
            beta.data_ptr(), dx.data_ptr(), dn.data_ptr(),
            dn_sums.data_ptr(), n, C, code, int(inverse), stream),
            "gdn_bwd_dx")
        # f32 has no tile sums: its partials sum the f32 scratch
        return (dx, dn) if x.dtype == torch.float32 else (dx, dn, dn_sums)

    def run_partials():
        check(lib.lmic_gdn_bwd_partials(x.data_ptr(), dn.data_ptr(),
                                        dn_sums.data_ptr(),
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


def _dx_plain(x, beta, gamma, g, inverse, tile_rows):
    """gdn_bwd_dx's outputs in plain torch, as gdn_bwd_reference forms
    them: (dx, the f32 dn) for f32; for bf16 (dx, dn rounded to bf16, the
    f32 dn summed over each tile of `tile_rows` rows)."""
    import torch

    x32, g32 = x.float(), g.float()
    norm = torch.matmul((x * x).float(), gamma.float().t()) + beta.float()
    if inverse:
        dn, scale = 0.5 * g32 * x32 * torch.rsqrt(norm), torch.sqrt(norm)
    else:
        dn, scale = -0.5 * g32 * x32 * norm ** -1.5, torch.rsqrt(norm)
    dnx = dn.to(x.dtype).float()
    dx = g32 * scale + 2.0 * x32 * torch.matmul(dnx, gamma.float())
    if x.dtype == torch.float32:
        return dx.to(x.dtype), dn
    return dx.to(x.dtype), dn.to(x.dtype), _row_sums(dn, tile_rows)


def _row_sums(t, rows):
    """The sums of `t` (n, C) over each run of `rows` rows, the last one
    padded with zeros."""
    import torch

    n, C = t.shape
    k = -(-n // rows)
    pad = torch.zeros((k * rows - n, C), device=t.device, dtype=t.dtype)
    return torch.cat([t, pad]).view(k, rows, C).sum(1)


def _partials_plain(x, dn, dn_sums, rows, tile_rows):
    """gdn_bwd_partials' output in plain torch: per chunk of `rows` rows,
    dn (rounded to x's type) transposed times x^2, then dbeta: the sum of
    the f32 dn (f32), or of the chunk's sums over tiles of `tile_rows`
    rows (bf16)."""
    import torch

    n, C = x.shape
    chunks = -(-n // rows)
    pad = torch.zeros((chunks * rows - n, C), device=x.device)
    d = torch.cat([dn.float(), pad]).view(chunks, rows, C)
    x2 = torch.cat([(x * x).float(), pad]).view(chunks, rows, C)
    dgamma = torch.bmm(d.to(x.dtype).float().transpose(1, 2), x2)
    if dn_sums is None:
        dbeta = d.sum(1)
    else:
        dbeta = _row_sums(dn_sums, rows // tile_rows)
    return (torch.cat([dgamma.reshape(chunks, C * C), dbeta], 1),)


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


def _record(cases, name, n, C, dtype, inverse, work, peak, mem_bw,
            **extra):
    """One case of `name` at n x C: `work` (run, plain, composite, bytes,
    operations) checked against its plain version at TOL (f32 `gdn_fwd`
    exactly) and for determinism, timed beside its bound, and appended to
    cases[name] with `extra`."""
    import torch

    run, plain, composite, nbytes, ops = work
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
        "shape": [n, C], "dtype": dtype, "inverse": inverse, **extra,
        "max_abs_err": err, "max_rel_err": rel,
        "us": 1e3 * _time_ms(run),
        "plain_us": 1e3 * _time_ms(plain),
        "library_us": 1e3 * _time_ms(composite),
        "bound_us": 1e6 * max(t_mem, t_ops),
        "bound_by": ("operations" if t_ops > t_mem else "bytes"),
        "bytes_us": 1e6 * t_mem, "operations_us": 1e6 * t_ops,
    })


def _fwd_work(x, beta, gamma, gamma_t, inverse):
    """gdn_fwd's (run, plain, composite, bytes, operations) on these
    inputs."""
    import torch

    from lmic_tpu_torch.ops import gdn

    n, C = x.shape
    rs = torch.sqrt if inverse else torch.rsqrt
    return (
        lambda: (gdn.gdn_fwd(x, beta, gamma, inverse),),
        lambda: (gdn.gdn_reference(x, beta, gamma, inverse),),
        lambda: x * rs(torch.addmm(beta, x * x, gamma_t)),
        # x read, y written, gamma and beta read
        (2 * n * C + C * C + C) * x.element_size(),
        2 * n * C * C + 4 * n * C,
    )


def phase_kernel(peaks):
    """Both GDN kernels against their plain versions at every main-path
    shape (serving, training, the RGB-T pair's wire and its training
    step, the batched synthesis of phase 12), and the bf16 forward and
    the backward's launches at two shapes off the wide kernels' route;
    returns the per-shape cases of each."""
    import torch

    from lmic_tpu_torch.ops import gdn

    mem_bw, fp32, bf16 = peaks
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {k: [] for k in ("gdn_fwd", "gdn_bwd") + gdn.BWD_KERNELS}
    routes = []  # each bf16 forward's and each dx launch's route
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
                # C is 128 or 192, every tensor 16-byte aligned
                fwd = ("gdn_fwd_kernel" if es == 4
                       else "gdn_fwd_wide_kernel")
                if dtype == "bfloat16":
                    routes.append((n, C, dt, 0, inverse, "gdn_fwd", fwd))
                _record(cases, "gdn_fwd", n, C, dtype, inverse,
                        _fwd_work(x, beta, gamma, gamma_t, inverse), peak,
                        mem_bw, kernel=fwd)
                if n in fwd_only:
                    continue
                kernel = ("gdn_bwd_dx_kernel" if es == 4
                          else "gdn_bwd_dx_wide_kernel")
                routes.append((n, C, dt, 0, inverse, "gdn_bwd_dx", kernel))
                _bwd_kernel_cases(cases, x, beta, gamma, gamma_t, g,
                                  inverse, peak, mem_bw, fp32, kernel)
                _record(cases, "gdn_bwd", n, C, dtype, inverse, (
                    lambda: gdn.gdn_bwd(x, beta, gamma, g, inverse),
                    lambda: gdn.gdn_bwd_reference(x, beta, gamma, g,
                                                  inverse),
                    lambda: _bwd_composite(x, beta, gamma, gamma_t, g,
                                           inverse),
                    # x and g read, dx written; gamma, beta read; dgamma,
                    # dbeta written
                    (3 * n * C + 2 * (C * C + C)) * es,
                    6 * n * C * C + 12 * n * C), peak, mem_bw)
            del x, beta, gamma, g, gamma_t
    # bf16 off the wide kernels' TMA route, on gdn_fwd_mma_kernel and
    # gdn_bwd_dx_mma_kernel: a view offset by one element, and a width the
    # wide kernels have no instance of
    for n, C, offset in ((16_391, 192, 1), (16_391, 320, 0)):
        x, beta, gamma, g = _gdn_inputs(gen, n, C, torch.bfloat16)
        buf = torch.empty(n * C + offset, dtype=x.dtype, device="cuda")
        buf[offset:].copy_(x.view(-1))
        x = buf[offset:].view(n, C)
        gamma_t = gamma.t().contiguous()
        for inverse in (False, True):
            routes.append((n, C, x.dtype, offset, inverse, "gdn_fwd",
                           "gdn_fwd_mma_kernel"))
            _record(cases, "gdn_fwd", n, C, "bfloat16", inverse,
                    _fwd_work(x, beta, gamma, gamma_t, inverse), bf16,
                    mem_bw, kernel="gdn_fwd_mma_kernel", offset=offset)
            routes.append((n, C, x.dtype, offset, inverse, "gdn_bwd_dx",
                           "gdn_bwd_dx_mma_kernel"))
            _bwd_kernel_cases(cases, x, beta, gamma, gamma_t, g, inverse,
                              bf16, mem_bw, fp32, "gdn_bwd_dx_mma_kernel")
        del x, beta, gamma, g, buf, gamma_t
    _check_routes(gen, routes)
    return cases


DX_KERNELS = ("gdn_bwd_dx_kernel", "gdn_bwd_dx_mma_kernel",
              "gdn_bwd_dx_wide_kernel")
FWD_KERNELS = ("gdn_fwd_kernel", "gdn_fwd_mma_kernel", "gdn_fwd_wide_kernel")


def _routed_kernels(run):
    """The forward and dx kernels that `run` launches, by name, in the
    order they ran on the device (one torch.profiler session)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ran = sorted((e.time_range.start, k) for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 for k in FWD_KERNELS + DX_KERNELS if k in e.name)
    return [k for _, k in ran]


def _check_routes(gen, routes):
    """One launch for each (n, C, dtype, offset, inverse, launch, kernel)
    of `routes` (launch: "gdn_fwd" through gdn.gdn_fwd, or "gdn_bwd_dx"
    through the C ABI), on fresh inputs of that shape and type whose x
    starts `offset` elements past an aligned base, all in one profiler
    session: the C ABI must count one launch of `kernel` and none of
    another (`gdn.kernel_launches`), and the trace's records must name
    those kernels in that order (a session may lose records, which is
    logged, but shows none out of order)."""
    import torch

    from lmic_tpu_torch.ops import gdn

    counted = []

    def run():
        for n, C, dt, offset, inverse, launch, _ in routes:
            x, beta, gamma, g = _gdn_inputs(gen, n, C, dt)
            buf = torch.empty(n * C + offset, dtype=dt, device="cuda")
            buf[offset:].copy_(x.view(-1))
            x = buf[offset:].view(n, C)
            torch.cuda.synchronize()
            before = gdn.kernel_launches()
            if launch == "gdn_fwd":
                gdn.gdn_fwd(x, beta, gamma, inverse)
            else:
                _bwd_launches(x, beta, gamma, gamma.t().contiguous(), g,
                              inverse)["gdn_bwd_dx"]()
            torch.cuda.synchronize()
            counted.append({k: v - before.get(k, 0) for k, v in
                            gdn.kernel_launches().items()
                            if v != before.get(k, 0)})

    ran = _routed_kernels(run)
    want = [r[-1] for r in routes]
    bad = [(r[:6], k) for r, k in zip(routes, counted) if k != {r[-1]: 1}]
    if bad:
        raise AssertionError(f"routes: {len(bad)} of {len(want)} launches "
                             f"took another kernel; first: {bad[:3]}")
    left = iter(want)  # each record is the next of `want`, or one past it
    if not all(k in left for k in ran):
        raise AssertionError(f"routes: the trace names {ran}, not the "
                             f"launches' kernels {want} in order")
    if len(ran) < len(want):
        log(f"routes: the trace lost the records of "
            f"{len(want) - len(ran)} of {len(want)} launches")
    log("gdn_fwd and gdn_bwd_dx routes: " + json.dumps(
        {k: want.count(k) for k in FWD_KERNELS + DX_KERNELS})
        + " launches as the rule says")


def _bwd_kernel_cases(cases, x, beta, gamma, gamma_t, g, inverse, peak,
                      mem_bw, fp32, dx_kernel):
    """Each of gdn_bwd's three launches against its plain version on the
    same inputs (the kernel's own dn and partials feed the next two), timed
    on its own, with its own bound; the dx cases name `dx_kernel`, the
    kernel their route takes, which `_check_routes` holds."""
    import torch

    from lmic_tpu_torch.ops import gdn

    n, C = x.shape
    es, dt = x.element_size(), x.dtype
    launch = _bwd_launches(x, beta, gamma, gamma_t, g, inverse)
    dx_out = launch["gdn_bwd_dx"]()
    dn = dx_out[1]  # f32 for f32; bf16, with the tile sums, for bf16
    dn_sums = dx_out[2] if len(dx_out) > 2 else None
    partials = launch["gdn_bwd_partials"]()[0]
    lib = gdn._load("gdn_bwd.cu")
    rows = lib.lmic_gdn_bwd_chunk_rows()
    tile_rows = lib.lmic_gdn_bwd_tile_rows()
    chunks = partials.shape[0]
    ccc = C * C + C
    dn_bytes = n * C * dn.element_size()
    sums_bytes = 0 if dn_sums is None else 4 * dn_sums.numel()
    work = {  # plain, library call, bytes, operations, peak
        "gdn_bwd_dx": (
            lambda: _dx_plain(x, beta, gamma, g, inverse, tile_rows),
            lambda: _dx_composite(x, beta, gamma, gamma_t, g, inverse),
            # x, g read; dx, the dn scratch and (bf16) its tile sums
            # written; gamma, beta read
            3 * n * C * es + dn_bytes + sums_bytes + ccc * es,
            4 * n * C * C + 12 * n * C, peak),
        "gdn_bwd_partials": (
            lambda: _partials_plain(x, dn, dn_sums, rows, tile_rows),
            _partials_library(x, dn, rows),
            # x, the dn scratch and (bf16) its tile sums read; the
            # partials written
            n * C * es + dn_bytes + sums_bytes + 4 * chunks * ccc,
            # dn^T . x^2 and x^2; dbeta's adds: every f32 dn (f32) or the
            # tile sums (bf16)
            2 * n * C * C + n * C
            + (n * C if dn_sums is None else dn_sums.numel()), peak),
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
            **({"dx_kernel": dx_kernel} if name == "gdn_bwd_dx" else {}),
            "us": 1e3 * _time_ms(run),
            "plain_us": 1e3 * _time_ms(plain),
            "library_us": 1e3 * _time_ms(library),
            "bound_us": 1e6 * max(t_mem, t_ops),
            "bound_by": "operations" if t_ops > t_mem else "bytes",
            "bytes_us": 1e6 * t_mem, "operations_us": 1e6 * t_ops,
        })


def _bf16_layers(cases, kernel):
    """bf16 `kernel` ("gdn_fwd" or "gdn_bwd_dx") at each layer of a
    training step, C = 192 and 128: µs of the GDN and the IGDN launch
    beside the bound and the composite (the library call)."""
    layers = {}
    for C in (192, 128):
        for n in TRAIN_ROWS[:3]:
            sel = sorted((c for c in cases[kernel]
                          if c["shape"] == [n, C]
                          and c["dtype"] == "bfloat16"),
                         key=lambda c: c["inverse"])
            layers[f"{n}x{C}"] = {
                "us": [c["us"] for c in sel],
                "bound_us": sel[0]["bound_us"],
                "bound_by": sel[0]["bound_by"],
                "library_us": [c["library_us"] for c in sel]}
    return layers


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
# the CUDA kernels behind each launch of ops/gdn.py, by dtype and route
CUDA_KERNELS = {
    "gdn_fwd": ["gdn_fwd_kernel (f32)",
                "gdn_fwd_wide_kernel (bf16, C = 128 and 192, 16-byte rows)",
                "gdn_fwd_mma_kernel (bf16, other shapes)"],
    "gdn_bwd_dx": ["gdn_bwd_dx_kernel (f32)",
                   "gdn_bwd_dx_wide_kernel (bf16, C = 128 and 192, 16-byte "
                   "rows)", "gdn_bwd_dx_mma_kernel (bf16, other shapes)"],
    "gdn_bwd_partials": ["gdn_bwd_partials_kernel (f32)",
                         "gdn_bwd_partials_wide_kernel (bf16)"],
    "gdn_bwd_reduce": ["gdn_bwd_reduce_kernel"],
}
# launches of the bf16 forward and dx kernels in an AMP step at C = 192
AMP_WIDE = {"gdn_fwd_wide_kernel": 6, "gdn_fwd_mma_kernel": 0,
            "gdn_bwd_dx_wide_kernel": 6, "gdn_bwd_dx_mma_kernel": 0}
def _hold_launches(what, counted, seen, want):
    """The launches a call of a profiled run made of each CUDA kernel, as
    the C ABI counted them where each launch succeeded (`counted`), must
    be `want` ({kernel: launches}); the trace's records of them (`seen`)
    name the kernels that ran on the device, and may miss a launch (on an
    NVIDIA H100 a session can lose records: one of 80 lost its first 19
    device operations, and phase 13's profiled steps lose one forward at
    times; a loss is logged) but never show one more."""
    if any(counted.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"{what}: launched {counted} a call, expected "
                             f"{want}")
    if any(v > counted.get(k, 0) for k, v in seen.items()):
        raise AssertionError(f"{what}: the trace shows {seen} a call, more "
                             f"than the {counted} launched")
    lost = {k: v - seen.get(k, 0) for k, v in counted.items()
            if k in GDN_KERNELS and seen.get(k, 0) < v}
    if lost:
        log(f"{what}: the trace lost the records of {lost} launches a call")


def _profile(run, n=3, keep=12, launches=None, counted=None):
    """Device time per call of `run` of the GDN kernels and of all
    kernels, the wall time per call, the device ms per call of each GDN
    kernel and of the other kernels that take the most (`keep` of them;
    None: all), and the device operations per call, from a
    torch.profiler trace of n calls. A `launches` dict gets each GDN
    kernel's launches per call as the trace records them, a `counted` dict
    as the C ABI counts them (`gdn.kernel_launches`; see
    `_hold_launches`)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lmic_tpu_torch.ops import gdn

    torch.cuda.synchronize()
    before = gdn.kernel_launches()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    if counted is not None:
        counted.update({k: (v - before.get(k, 0)) / n for k, v in
                        gdn.kernel_launches().items()
                        if v != before.get(k, 0)})
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
            if launches is not None:
                launches[name] = launches.get(name, 0) + evt.count / n
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
        per_step, counted = {}, {}
        gdn_ms, dev_ms, wall_ms, top, _ = _profile(
            lambda: step(state, batch, gen), launches=per_step,
            counted=counted)
        log(f"train {mode} GDN kernel launches a step: {counted}")
        # bf16 at C = 192: the wide kernels, never the mma ones
        _hold_launches(f"train {mode}", counted, per_step,
                       AMP_WIDE if mode == "amp" else {})
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


def _train_case(what, step, state, batches, gen, timed, per_step,
                kernels=None, exact=False, out=None):
    """A warm-up step, a second one under the profiler, then `timed`
    steps with the launch counts set to 0 just before and read just
    after, which must be `per_step` of each kernel a step; the loss must
    stay finite and fall on the one batch. `kernels` maps CUDA kernel
    names to the launches the profiled step must make (`_hold_launches`),
    and with `exact` each timed step too, as the C ABI counts them.
    Logs the step ms, peak memory and the profiled step, and puts the
    median step ms, the profiled step's device ms and busy share and the
    peak memory in the dict `out` when given. Returns the launch counts
    of the timed steps."""
    import torch

    from lmic_tpu_torch.ops import gdn

    t0 = time.perf_counter()
    metrics = []

    def one():
        _, m = step(state, *batches, gen)
        metrics.append({k: float(v) for k, v in m.items()})

    one()
    seen, counted = {}, {}
    gdn_ms, dev_ms, wall_ms, top, ops = _profile(one, n=1, keep=None,
                                                 launches=seen,
                                                 counted=counted)
    _hold_launches(f"{what}, the profiled step", counted, seen,
                   kernels or {})
    t_warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    before = gdn.kernel_launches()
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
    if exact:
        after = gdn.kernel_launches()
        abi = {k: after.get(k, 0) - before.get(k, 0) for k in kernels}
        if abi != {k: v * timed for k, v in kernels.items()}:
            raise AssertionError(f"{what}: the C ABI counted {abi} in "
                                 f"{timed} steps, expected {kernels} a "
                                 "step")
    if out is not None:
        out.update(step_ms=float(np.median(ms)), device_ms=dev_ms,
                   busy=dev_ms / wall_ms, peak_gib=peak / 2**30,
                   kernels=top)
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
                                  list(top.items())[:10]})
        + f"; GDN kernel launches {json.dumps(seen)}")
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
        # AMP: each GDN twice on the wide forward, once on the wide dx
        launched = _train_case(
            f"{TRAIN_ARCH} q{TRAIN_QUALITY} {mode} --remat batch "
            f"{TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}x{TRAIN_BATCH[2]}",
            step, state, (batch,), gen, 4, REMAT_STEP,
            {k: 2 * v if k.startswith("gdn_fwd") else v
             for k, v in AMP_WIDE.items()} if dtype else None)
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


BF16 = "bfloat16"


def _abi_diff(before):
    """Launches of each GDN CUDA kernel since `before`, by the C ABI."""
    from lmic_tpu_torch.ops import gdn

    after = gdn.kernel_launches()
    return {k: after.get(k, 0) - before.get(k, 0) for k in GDN_KERNELS}


def _hold_abi(what, counted, per_pass, passes):
    """The C ABI's launches (`counted`) of `passes` passes: `per_pass`
    f32 `gdn_fwd_kernel` each, and no other GDN kernel (no backward, no
    bf16 kernel: the GDN is HIGHEST in lmic_tpu, f32 under the mode)."""
    want = {k: 0 for k in GDN_KERNELS}
    want["gdn_fwd_kernel"] = per_pass * passes
    if counted != want:
        raise AssertionError(f"{what}: the C ABI counted {counted}, "
                             f"expected {want}")


def _engines(top):
    """The conv and GEMM kernels of a profile, by name (cuDNN's and
    cuBLAS's engines; TF32 ones carry `tf32` in their names), with those
    that transform the operands (FFT, Winograd) apart."""
    names = [k for k in top if any(w in k.lower() for w in (
        "conv", "gemm", "xmma", "tf32", "fft", "winograd", "cutlass"))]
    return names, [k for k in names
                   if "fft" in k.lower() or "winograd" in k.lower()]


def _half_cpu_agreement(arch, quality, codec):
    """The card's transforms under the bf16 mode against the CPU's under
    the mode, same seed, on a 64x128 image: y, z and g_s of the CPU's
    rounded latents, within HALF_BAR of the largest value; for an AR
    codec every wavefront step's scales and means on the CPU's coded
    latents too. Returns the largest error."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import precision
    from lmic_tpu_torch.utils.crosscheck import wavefront_step_agreement

    cpu = zoo.create_model(arch, quality, seed=0, device="cpu")
    cpu.update()
    x = _images(1, (1, 64, 128, 3), seed=7)[0]
    worst = 0.0
    with torch.inference_mode(), precision.matmul_precision(BF16):
        y_ref, z_ref = cpu.module.analyze(cpu._pixels(x))
        y_hat = torch.round(y_ref)
        y, z = codec.module.analyze(codec._pixels(x))
        pairs = ((y, y_ref), (z, z_ref), (codec.module.g_s(
            y_hat.to(codec.device)), cpu.module.g_s(y_hat)))
        for a, b in pairs:
            worst = max(worst, ((a.float().cpu() - b).abs().max()
                                / b.abs().max()).item())
        if hasattr(codec, "_step_for"):
            err, flips, n = wavefront_step_agreement(codec, cpu, x)
            log(f"--half {arch} q{quality}: CUDA vs CPU wavefront steps "
                f"within {err:.3g}, {flips} of {n} scale indexes differ")
            worst = max(worst, err)
    if not worst <= HALF_BAR:
        raise AssertionError(f"--half {arch}: CUDA vs CPU {worst:.3g}")
    return worst


def _half_codec(arch, quality, images):
    """`eval_model --half`'s cores on one codec from seed 0: the f32
    round trips, then under the mode `eval_image_codec` and
    `eval_image_forward` on each image with the counts set to 0 just
    before and read just after (6 f32 `gdn_fwd_kernel` a round trip and
    an estimate, nothing else), the strings other than f32's and decoding
    to the encoder's latents, the tables untouched, the card against the
    CPU. Returns the `gdn_fwd` launches of the counted calls."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.models.joint import JointARCodec
    from lmic_tpu_torch.ops import gdn, precision
    from lmic_tpu_torch.utils.eval_model import (
        eval_image_codec,
        eval_image_forward,
    )

    codec = zoo.create_model(arch, quality, seed=0, device="cuda")
    codec.update()
    tables = [getattr(codec, k).table.cdf.copy()
              for k in ("eb_state", "gc_state")]
    xs = [img.astype(np.float32) / 255 for img in images]
    f32 = [codec.compress(x)["strings"] for x in xs]
    f32_ms = [eval_image_codec(codec, x) for x in xs]
    f32_dev = _profile(lambda: eval_image_codec(codec, xs[0]), n=1)[1]
    with precision.matmul_precision(BF16):
        eval_image_codec(codec, xs[0])  # the mode's first launches
        precision.reset_rounded_calls()
        torch.cuda.synchronize()
        before = gdn.kernel_launches()
        _reset_counts()
        half_ms = [eval_image_codec(codec, x) for x in xs]
        rounded = precision.rounded_calls() / len(xs)
        estimates = [eval_image_forward(codec, x) for x in xs]
        torch.cuda.synchronize()
        launched = gdn.LAUNCHES["gdn_fwd"]
        _hold_abi(f"--half {arch}", _abi_diff(before), 6, 2 * len(xs))
        if launched != 12 * len(xs):
            raise AssertionError(f"--half {arch}: gdn_fwd launched "
                                 f"{launched}")
        for x, want in zip(xs, f32):
            out = codec.compress(x)
            if out["strings"] == want:
                raise AssertionError(f"--half {arch}: the f32 strings")
            if isinstance(codec, JointARCodec):
                _ar_roundtrip_checks(codec, x, out["strings"])
            else:
                _roundtrip_checks(codec, x, out["strings"], out["shape"])
        gdn_ms, dev_ms, wall_ms, top, ops = _profile(
            lambda: eval_image_codec(codec, xs[0]), n=1, keep=None)
    if not all(np.array_equal(a, getattr(codec, k).table.cdf)
               for a, k in zip(tables, ("eb_state", "gc_state"))):
        raise AssertionError(f"--half {arch}: the tables moved")
    if codec.compress(xs[0])["strings"] != f32[0]:
        raise AssertionError(f"{arch}: f32 strings after --half differ")
    worst = _half_cpu_agreement(arch, quality, codec)
    engines, transforming = _engines(top)

    def med(ms, key):
        return float(np.median([1e3 * m[key] for m in ms]))

    log(f"--half {arch} q{quality} on {len(xs)} 512x768 images: "
        f"{rounded:.0f} rounded calls a round trip; encode / decode ms "
        f"f32 {med(f32_ms, 'encoding_time'):.2f} / "
        f"{med(f32_ms, 'decoding_time'):.2f}, --half "
        f"{med(half_ms, 'encoding_time'):.2f} / "
        f"{med(half_ms, 'decoding_time'):.2f}; bpp f32 "
        f"{np.mean([m['bpp'] for m in f32_ms]):.4f} --half "
        f"{np.mean([m['bpp'] for m in half_ms]):.4f}, PSNR f32 "
        f"{np.mean([m['psnr'] for m in f32_ms]):.3f} --half "
        f"{np.mean([m['psnr'] for m in half_ms]):.3f} dB; estimate bpp "
        f"{np.mean([m['bpp'] for m in estimates]):.4f}; a round trip's "
        f"device ms f32 {f32_dev:.2f}, --half {dev_ms:.2f} of {wall_ms:.2f} "
        f"(busy "
        f"{100 * dev_ms / wall_ms:.1f} %), GDN {gdn_ms:.3f} ms, {ops:.0f} "
        f"device operations; CUDA vs CPU within {worst:.3g}; conv and "
        f"GEMM engines {json.dumps(engines)}")
    if transforming:
        log(f"--half {arch}: engines that transform the operands: "
            f"{transforming}")
    return launched


def _half_rgbt(images):
    """The RGB-T pair q7 (channel 1) under the mode: `eval_rgbt_pair` on a
    512x640 master and a 1024x1280 guide with the counts set to 0 just
    before and read just after (12 f32 `gdn_fwd_kernel`), the checks of
    phase 7 (`_rgbt_checks`: exact latents, the guide's reconstruct) on
    strings other than f32's, the tables untouched, the card against the
    CPU stage by stage. Returns the `gdn_fwd` launches counted."""
    import torch

    from lmic_tpu_torch.ops import gdn, precision
    from lmic_tpu_torch.utils.crosscheck import rgbt_agreement
    from lmic_tpu_torch.utils.eval_model import eval_rgbt_pair
    from lmic_tpu_torch.utils.serve import load_rgbt_codecs

    (guided, master), _ = load_rgbt_codecs(RGBT_QUALITY, 1, seed=0,
                                           device="cuda")
    tables = [getattr(c, k).table.cdf.copy() for c in (guided, master)
              for k in ("eb_state", "gc_state")]
    x = _images(1, RGBT_MASTER, seed=31)[0].astype(np.float32) / 255
    guide = _images(1, RGBT_GUIDE, seed=32)[0].astype(np.float32) / 255
    f32 = _rgbt_checks(guided, master, x, guide)[0]["strings"]
    f32_m = eval_rgbt_pair(guided, master, x, guide)
    f32_dev = _profile(lambda: eval_rgbt_pair(guided, master, x, guide),
                       n=1)[1]
    with precision.matmul_precision(BF16):
        eval_rgbt_pair(guided, master, x, guide)
        precision.reset_rounded_calls()
        torch.cuda.synchronize()
        before = gdn.kernel_launches()
        _reset_counts()
        half_m = eval_rgbt_pair(guided, master, x, guide)
        torch.cuda.synchronize()
        launched = gdn.LAUNCHES["gdn_fwd"]
        rounded = precision.rounded_calls()
        _hold_abi("--half RGB-T", _abi_diff(before), 12, 1)
        if launched != 12:
            raise AssertionError(f"--half RGB-T: gdn_fwd launched "
                                 f"{launched}")
        out = _rgbt_checks(guided, master, x, guide)[0]
        if out["strings"] == f32:
            raise AssertionError("--half RGB-T: the f32 strings")
        gdn_ms, dev_ms, wall_ms, top, ops = _profile(
            lambda: eval_rgbt_pair(guided, master, x, guide), n=1,
            keep=None)
        cpu, _ = load_rgbt_codecs(RGBT_QUALITY, 1, seed=0, device="cpu")
        factor = master.module.downsampling_factor
        gH, gW = master.expected_guide_hw(factor, factor)
        worst = rgbt_agreement(
            (guided, master), cpu,
            _images(1, (1, factor, factor, 1), seed=41)[0],
            _images(1, (1, gH, gW, 3), seed=42)[0])
    if not all(np.array_equal(a, getattr(c, k).table.cdf) for a, (c, k) in
               zip(tables, [(c, k) for c in (guided, master)
                            for k in ("eb_state", "gc_state")])):
        raise AssertionError("--half RGB-T: the tables moved")
    if not worst <= HALF_BAR:
        raise AssertionError(f"--half RGB-T: CUDA vs CPU {worst:.3g}")
    engines, transforming = _engines(top)
    log(f"--half RGB-T q{RGBT_QUALITY} (512x640 master, 1024x1280 guide): "
        f"{rounded} rounded calls a pair; encode / decode ms f32 "
        f"{1e3 * f32_m['encoding_time']:.2f} / "
        f"{1e3 * f32_m['decoding_time']:.2f}, --half "
        f"{1e3 * half_m['encoding_time']:.2f} / "
        f"{1e3 * half_m['decoding_time']:.2f}; bpp f32 {f32_m['bpp']:.4f} "
        f"--half {half_m['bpp']:.4f}; device ms f32 {f32_dev:.2f}, --half "
        f"{dev_ms:.2f} of {wall_ms:.2f} (busy {100 * dev_ms / wall_ms:.1f} "
        f"%), GDN "
        f"{gdn_ms:.3f} ms, {ops:.0f} device operations; CUDA vs CPU stage "
        f"by stage within {worst:.3g}; conv and GEMM engines "
        f"{json.dumps(engines)}")
    if transforming:
        log(f"--half RGB-T: engines that transform the operands: "
            f"{transforming}")
    return launched


def _narrow_step(device, mode):
    """One step of a narrow mbt2018-mean (q7, N = 32, M = 48) from seed 0
    on a seeded batch of 2 of 64x128 on `device` under
    `crosscheck.fixed_noise`, in the matmul precision `mode`: (metrics,
    {name: clipped gradient, f64 on the CPU})."""
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.crosscheck import fixed_noise
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    x = _train_batch((2, 64, 128, 3), seed=11).to(device)
    module = zoo.create_model(TRAIN_ARCH, TRAIN_QUALITY, seed=0,
                              device=device, N=32, M=48).module
    opt = make_optimizer()
    with fixed_noise():
        _, m = make_train_step(module, opt, TRAIN_LAMBDA,
                               matmul_precision=mode)(
            create_train_state(module, opt), x)
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().double().cpu()
             for n, p in module.named_parameters()})


def _step_gap(a, b):
    """Step `a` against step `b` (`_narrow_step`'s): the losses' largest
    relative difference, the clipped gradients' relative Frobenius error
    as one vector, the root mean square of each leaf's, and the six
    leaves with the largest max|a - b| / max|b|."""
    (m_a, g_a), (m_b, g_b) = a, b
    loss = max(abs(m_a[k] - m_b[k]) / abs(m_b[k]) for k in m_b)
    whole = float(np.sqrt(sum((g_a[n] - g_b[n]).norm().item() ** 2
                              for n in g_b)
                          / sum(g_b[n].norm().item() ** 2 for n in g_b)))
    rms = float(np.sqrt(np.mean([((g_a[n] - g_b[n]).norm()
                                  / g_b[n].norm()).item() ** 2
                                 for n in g_b])))
    leaves = sorted(((((g_a[n] - g_b[n]).abs().max()
                       / g_b[n].abs().max()).item(), n) for n in g_b),
                    reverse=True)[:6]
    return loss, whole, rms, {n: round(e, 4) for e, n in leaves}


def _bf16_steps():
    """mbt2018-mean q7 at batch 16 of 256x256: f32, AMP, --bf16 and --bf16
    --remat steps from seed 0 in one process (a warm-up, a profiled and 4
    timed steps each; under --bf16 the C ABI's exact launches, BF16_STEP
    and BF16_REMAT_STEP a step), then one narrow --bf16 step on the card
    against the CPU with the same noise (`_narrow_step`).
    Returns the launch counts of the timed steps."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn, precision
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    batch = _train_batch(TRAIN_BATCH, seed=1)
    counts = {k: 0 for k in gdn.LAUNCHES}
    results = {}
    for mode, dtype, remat, mp, per_step, kernels in (
            ("f32", None, False, None, 6, None),
            ("amp", torch.bfloat16, False, None, 6, AMP_WIDE),
            ("bf16", None, False, BF16, 6, BF16_STEP),
            ("bf16 --remat", None, True, BF16, 12, BF16_REMAT_STEP)):
        module = zoo.create_model(TRAIN_ARCH, TRAIN_QUALITY, seed=0,
                                  device="cuda", dtype=dtype).module
        opt = make_optimizer()
        state = create_train_state(module, opt)
        gen = torch.Generator(device="cuda").manual_seed(0)
        step = make_train_step(module, opt, TRAIN_LAMBDA, remat=remat,
                               matmul_precision=mp)
        precision.reset_rounded_calls()
        out = {}
        launched = _train_case(
            f"{TRAIN_ARCH} q{TRAIN_QUALITY} {mode} batch "
            f"{TRAIN_BATCH[0]}x{TRAIN_BATCH[1]}x{TRAIN_BATCH[2]}", step,
            state, (batch,), gen, 4,
            {"gdn_fwd": per_step, "gdn_bwd_dx": 6, "gdn_bwd_partials": 6,
             "gdn_bwd_reduce": 6}, kernels, exact=mp is not None, out=out)
        out["rounded"] = precision.rounded_calls() / 6
        results[mode] = out
        if mp is not None:
            for k, v in launched.items():
                counts[k] += v
        del module, state, opt, step
        torch.cuda.empty_cache()
    engines, transforming = _engines(results["bf16"]["kernels"])
    for out in results.values():
        del out["kernels"]
    log("mbt2018-mean q7 step, one process (step ms median, the profiled "
        "step's device ms and busy share, peak GiB, rounded calls a "
        "step): " + json.dumps({k: {n: round(v, 4) for n, v in out.items()}
                                for k, out in results.items()}))
    log(f"--bf16 step's conv and GEMM engines: {json.dumps(engines)}")
    if transforming:
        log(f"--bf16 step: engines that transform the operands: "
            f"{transforming}")
    cpu = _narrow_step("cpu", BF16)
    loss_err, grad_err, _, worst = _step_gap(_narrow_step("cuda", BF16),
                                             cpu)
    effect = _step_gap(cpu, _narrow_step("cpu", None))[1]
    loss_bar, grad_ratio = BF16_STEP_BARS
    if not (loss_err <= loss_bar and grad_err <= grad_ratio * effect):
        raise AssertionError(
            f"--bf16 step on the card vs the CPU: loss {loss_err:.3g}, "
            f"gradients {grad_err:.3g} (the rounding's {effect:.3g})")
    log(f"--bf16 step on the card vs the CPU (N=32, M=48, same noise): "
        f"losses within {loss_err:.3g}, gradients as one vector within "
        f"{grad_err:.3g} against the rounding's own {effect:.3g}; worst "
        f"leaves {json.dumps(worst)}")
    return counts


def phase_matmul_precision():
    """Phase 14 (see the module doc): lmic_tpu's bf16 matmul precision,
    `eval_model --half` on mbt2018-mean q8, cheng2020-anchor q3 and the
    RGB-T pair q7, then `train_cli --bf16` (and `--remat`) beside f32 and
    AMP. Returns (the eval calls' `gdn_fwd` launches, the --bf16 steps'
    launch counts)."""
    t_phase = time.perf_counter()
    images = _images(HALF_IMAGES, seed=51)
    launches = sum(_half_codec(arch, q, images) for arch, q in HALF_CODECS)
    launches += _half_rgbt(images)
    t_eval = time.perf_counter() - t_phase
    counts = _bf16_steps()
    log(f"matmul precision phase: {time.perf_counter() - t_phase:.1f} s "
        f"(--half {t_eval:.1f} s)")
    return launches, counts


def _dp_step_ms(dtype, batch, data_parallel):
    """Median ms of DP_TIMED steps of phase 5's step (after a warm-up), in
    this process, with or without DDP (one rank), on the host clock."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.utils.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    module = zoo.create_model(TRAIN_ARCH, TRAIN_QUALITY, seed=0,
                              device="cuda", dtype=dtype).module
    opt = make_optimizer()
    step = make_train_step(module, opt, TRAIN_LAMBDA,
                           data_parallel=data_parallel)
    state = create_train_state(module, opt)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _steps(step, state, batch, gen, 1)
    ms, _ = _steps(step, state, batch, gen, DP_TIMED)
    return float(np.median(ms))


def _dp_kernels(what, kernel_launches, launches, dtype, steps):
    """The launches of one rank's checked steps: 6 a step of each wrapper
    (`launches`) and of its CUDA kernels as the C ABI counts them
    (`kernel_launches`), the AMP step's forward and dx on the wide
    kernels (`AMP_WIDE`)."""
    for name, n in launches.items():
        by_kernel = sum(v for k, v in kernel_launches.items()
                        if k.startswith(name + "_"))
        if n != 6 * steps or by_kernel != 6 * steps:
            raise AssertionError(f"{what}: launches {launches}, by kernel "
                                 f"{kernel_launches}; want {6 * steps} each")
    if dtype is not None:
        for k, v in AMP_WIDE.items():
            if kernel_launches.get(k, 0) != v * steps:
                raise AssertionError(f"{what}: by kernel {kernel_launches}")


def _dp_training():
    """Part 1 of phase 15: the DDP step in f32 and AMP. Returns the
    launch counts of the DDP runs (the one-rank group's and both ranks')."""
    import torch

    from lmic_tpu_torch import parallel
    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils import crosscheck

    x = _train_batch(TRAIN_BATCH, seed=61)
    counts = {k: 0 for k in gdn.LAUNCHES}
    two = parallel.Mesh(["cuda:0", "cuda:0"])
    args = (TRAIN_ARCH, TRAIN_QUALITY, x.cpu(), TRAIN_LAMBDA, "cuda")
    for mode, dtype in (("f32", None), ("amp", torch.bfloat16)):
        t0 = time.perf_counter()
        plain = crosscheck.data_parallel_steps(*args, steps=DP_STEPS,
                                               dtype=dtype)
        with parallel.process_group("nccl"):
            one = crosscheck.data_parallel_steps(
                *args, steps=DP_STEPS, dtype=dtype, data_parallel=True)
            ddp_ms = _dp_step_ms(dtype, x, True)
        plain_ms = _dp_step_ms(dtype, x, False)
        if not (one["metrics"] == plain["metrics"]
                and torch.equal(one["grads"], plain["grads"])
                and one["param_sha256"] == plain["param_sha256"]):
            raise AssertionError(
                f"{mode}: the one-rank NCCL step is not the plain step: "
                f"{one['metrics']} vs {plain['metrics']}")
        _dp_kernels(f"{mode} one-rank NCCL", one["kernel_launches"],
                    {k: one["launches"][k] for k in gdn.LAUNCHES}, dtype,
                    DP_STEPS)
        for k in counts:
            counts[k] += one["launches"][k]
        log(f"data parallel {mode}: one-rank NCCL DDP == plain step bit for "
            f"bit over {DP_STEPS} steps (metrics, gradients, parameters); "
            f"step ms {ddp_ms:.2f} under DDP vs {plain_ms:.2f} plain")
        with tempfile.TemporaryDirectory() as tmp:
            t1 = time.perf_counter()
            parallel.launch(crosscheck.data_parallel_rank, two, *args[:4],
                            DP_STEPS, dtype, DP_TIMED, tmp, backend="gloo")
            t_launch = time.perf_counter() - t1
            ranks = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False)
                     for r in range(two.size)]
        loss_err = max(abs(r["metrics"][i]["loss"] - m["loss"])
                       / abs(m["loss"]) for r in ranks
                       for i, m in enumerate(one["metrics"]))
        grad_err = float((ranks[0]["grads"] - one["grads"]).norm()
                         / one["grads"].norm())
        param_err = float((ranks[0]["params"] - one["params"]).norm()
                          / one["params"].norm())
        same = ranks[0]["param_sha256"] == ranks[1]["param_sha256"]
        for r, res in enumerate(ranks):
            _dp_kernels(f"{mode} gloo rank {r}", res["kernel_launches"],
                        res["launches"], dtype, DP_STEPS)
            for k in counts:
                counts[k] += res["launches"][k]
            log(f"data parallel {mode} gloo rank {r} of 2 "
                f"({TRAIN_BATCH[0] // 2} rows of "
                f"{TRAIN_BATCH[1]}x{TRAIN_BATCH[2]}): step ms "
                f"{json.dumps([round(v, 2) for v in res['step_wall_ms']])}, "
                f"device ms {res['step_device_ms']:.2f} of the profiled "
                f"step, all-reduce share of device time "
                f"{100 * res['allreduce_device_share']:.1f} % (gloo's host "
                f"copies), peak memory {res['peak_gib']:.2f} GiB, GDN "
                f"launches by kernel {res['kernel_launches']}")
        n_params = one["params"].numel()
        log(f"data parallel {mode}: two gloo ranks vs the one-rank step on "
            f"the whole {TRAIN_BATCH[0]}: losses within {loss_err:.3g} (bar "
            f"{DP_LOSS_RTOL}), gradient as one vector within "
            f"{grad_err:.3g} (bar {DP_GRAD_RTOL[mode]:.3g}), parameters "
            f"after "
            f"{DP_STEPS} steps within {param_err:.3g}, ranks' parameters "
            f"bit-equal after each step: {same}; {n_params} parameters, "
            f"{4 * n_params / 2**20:.1f} MiB all-reduced a step; spawn and "
            f"run {t_launch:.1f} s; mode {time.perf_counter() - t0:.1f} s")
        if not same:
            raise AssertionError(f"{mode}: the ranks' parameters differ")
        if not (loss_err <= DP_LOSS_RTOL
                and grad_err <= DP_GRAD_RTOL[mode]):
            raise AssertionError(
                f"{mode}: two gloo ranks vs one: losses {loss_err:.3g}, "
                f"gradient {grad_err:.3g}")
    return counts


def _fan_case(what, single, fanned, x, launches_of):
    """Round trips of `x` through the one-slot codec and the fanned-out
    one (a warm-up each, then one timed), strings byte-identical; logs
    images/s of each and the fanned-out round trip's GDN launches.
    `launches_of` is the fan-out's exact `gdn_fwd` launches a round trip.
    Returns them."""
    rates = {}
    outs = {}
    for name, codec in (("one slot", single), ("two slots", fanned)):
        rt = _fan_round_trip(codec, x)
        rt()
        (strings, pixels), counts, ms = _counted(rt)
        rates[name] = len(x) / (ms / 1e3)
        outs[name] = strings, pixels
        if name == "two slots":
            _only_fwd(what, counts, launches_of)
    (s1, p1), (s2, p2) = outs["one slot"], outs["two slots"]
    if s1 != s2:
        raise AssertionError(f"{what}: fanned-out strings differ")
    diff = int(np.abs(p1.astype(np.int16) - p2.astype(np.int16)).max())
    log(f"fan-out {what}: strings byte-identical to one slot; pixels max "
        f"level difference {diff}; images/s one slot "
        f"{rates['one slot']:.2f}, two slots {rates['two slots']:.2f}; "
        f"{launches_of} gdn_fwd a round trip")
    return launches_of


def _fan_round_trip(codec, x):
    """A round trip of `x`: (strings, uint8 pixels)."""
    def run():
        if x.ndim == 5:  # video: (frames' strings, shapes)
            strings, shapes = codec.compress(x)
            return strings, codec.decompress(strings, shapes, u8=True)
        out = codec.compress(x)
        return (out["strings"],
                codec.decompress(out["strings"], out["shape"],
                                 u8=True)["x_hat"])
    return run


def _cross_platform():
    """ROADMAP C's open question, logged and not held (lmic_tpu's contract
    is the same platform on both sides): mbt2018-mean q8 encoded on the
    card and decoded on the CPU, and the reverse, the card codec's tables
    on both. For each direction: the scale indexes the decoder derives
    that differ from the encoder's, whether the y symbols decode as
    encoded, and the largest pixel difference from the encoder side's
    own decode (or the error a desynced stream raised)."""
    import torch

    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.entropy import coder as rans

    x = _images(1, seed=65)[0]
    card = zoo.create_model(SERVE_ARCH, QUALITY, seed=0, device="cuda")
    card.update(force=True)
    cpu = zoo.create_model(SERVE_ARCH, QUALITY, seed=0, device="cpu")
    cpu.eb_state, cpu.gc_state = card.eb_state, card.gc_state
    outs = {"card": card.compress(x), "cpu": cpu.compress(x)}
    report = {"strings_equal": outs["card"]["strings"]
              == outs["cpu"]["strings"]}
    for enc_name, enc, dec in (("card", card, cpu), ("cpu", cpu, card)):
        out = outs[enc_name]
        y_strings, z_strings = out["strings"]
        z_sym = enc.eb_state.decode_symbols(z_strings, tuple(out["shape"]))
        with torch.inference_mode():
            idx = [c._params_for_wire_z(z_sym)[0] for c in (enc, dec)]
        side = {"index_flips": int((idx[0] != idx[1]).sum())}
        try:
            sym = [rans.decode_batch(y_strings, i.reshape(1, -1),
                                     enc.gc_state.table) for i in idx]
            side["symbols_equal"] = bool(np.array_equal(*sym))
            pix = [c.decompress(out["strings"], out["shape"],
                                u8=True)["x_hat"] for c in (enc, dec)]
            side["pixels_max_diff"] = int(np.abs(
                pix[0].astype(np.int16) - pix[1]).max())
        except (RuntimeError, ValueError) as e:  # a desynced stream
            side["decode_error"] = str(e)[:200]
        report[f"{enc_name}->{'cpu' if enc is card else 'card'}"] = side
    log(f"ROADMAP C, a stream coded on one platform decoded on the other "
        f"(mbt2018-mean q{QUALITY}, 512x768, the card's tables on both; "
        f"not a gate): {json.dumps(report)}")
    return report


def _dp_serving():
    """Parts 2-4 of phase 15: the fan-out over a two-slot mesh, a bundle
    exported from the sharded codec, a mixed device set. Returns the
    fanned-out round trips' `gdn_fwd` launches."""
    import torch

    from lmic_tpu_torch import parallel, zoo
    from lmic_tpu_torch.utils.aot import load_serving_bundle

    two = parallel.Mesh(["cuda:0", "cuda:0"])

    def pair(make):
        single, fanned = make(), make()
        for c in (single, fanned):
            c.update(force=True)
        return single, parallel.shard_codec(fanned, two)

    launches = 0
    single, sharded = pair(lambda: zoo.create_model(SERVE_ARCH, QUALITY,
                                                    seed=0, device="cuda"))
    x = np.concatenate(_images(FAN_IMAGES, seed=62))
    # 3 GDN an image to encode; the synthesis splits the batch into two
    # row blocks, 3 IGDN each
    launches += _fan_case(f"{SERVE_ARCH} q{QUALITY}, {FAN_IMAGES} images",
                          single, sharded, x, 3 * FAN_IMAGES + 3 * 2)
    xa = np.concatenate(_images(FAN_AR_IMAGES, seed=63))
    launches += _fan_case(
        f"{AR_SERVE_ARCH} q{AR_QUALITY}, {FAN_AR_IMAGES} images",
        *pair(lambda: zoo.create_model(AR_SERVE_ARCH, AR_QUALITY, seed=0,
                                       device="cuda")),
        xa, 3 * FAN_AR_IMAGES + 3)
    gops = np.concatenate(_gops(FAN_GOPS[0], shape=(1, *FAN_GOPS[1:]),
                                seed=64))
    launches += _fan_case(
        f"ssf2020, {FAN_GOPS[0]} sequences of {FAN_GOPS[1]} "
        f"{FAN_GOPS[2]}x{FAN_GOPS[3]} frames",
        *pair(lambda: zoo.create_video_model(seed=0, device="cuda")),
        gops, 0)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sharded")
        secs, mib = _export(sharded, path, x.shape)
        served = load_serving_bundle(path, mesh=two)
        want = sharded.compress(x)
        got, counts, _ = _counted(served.compress, x)
        _only_fwd("sharded bundle", counts, 3 * FAN_IMAGES)
        launches += 3 * FAN_IMAGES
        if got["strings"] != want["strings"]:
            raise AssertionError("the sharded bundle's strings differ")
        try:
            load_serving_bundle(path, mesh=parallel.Mesh(["cuda:0"] * 3))
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("a bundle for 2 devices took a mesh of 3")
        log(f"sharded bundle: exported in {secs:.1f} s ({mib:.1f} MiB, "
            f"nr_devices {served.bundle_meta['nr_devices']}), served over "
            f"the two-slot mesh with the live codec's strings; a mesh of 3 "
            f"refused: {refused}")
    try:
        parallel.check_homogeneous([torch.device("cuda", 0), "cpu"])
    except ValueError as e:
        log(f"check_homogeneous([cuda:0, cpu]) refused: {e}")
    else:
        raise AssertionError("check_homogeneous took a mixed device set")
    _cross_platform()
    return launches


def phase_data_parallel():
    """Phase 15 (see the module doc): data parallelism. Returns the
    launch counts of its main path, {wrapper: launches}: the DDP runs'
    and, under `gdn_fwd`, the fan-out's and the sharded bundle's."""
    t_phase = time.perf_counter()
    _reset_counts()
    counts = _dp_training()
    t_train = time.perf_counter() - t_phase
    counts["gdn_fwd"] += _dp_serving()
    log(f"data parallel phase: {time.perf_counter() - t_phase:.1f} s "
        f"(training {t_train:.1f} s); launches {counts}")
    return counts


def _apps_round_trip(codec, images):
    """Part 1 of phase 16: the round trip of phase 3 through
    `utils/profiling.py` (a device trace, an annotation, a `Timings`
    section a leg, `timed`), with each section's wall ms held to at least
    the CUDA-event device ms of its work. Returns the launch counts."""
    import torch

    from lmic_tpu_torch.ops import gdn
    from lmic_tpu_torch.utils import profiling

    timings = profiling.Timings()
    device_ms = {"compress": 0.0, "decompress": 0.0}
    enc_s = []
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        _reset_counts()
        before = gdn.kernel_launches()
        with profiling.device_trace(tmp), \
                profiling.annotate(APPS_ANNOTATION):
            for x in images:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                # each section ends once the card has reached its end event
                with timings.section("compress"):
                    ev[0].record()
                    out, s = profiling.timed(codec.compress, x)
                    ev[1].record()
                    ev[1].synchronize()
                enc_s.append(s)
                with timings.section("decompress"):
                    ev[2].record()
                    rec = codec.decompress(out["strings"], out["shape"],
                                           u8=True)
                    ev[3].record()
                    ev[3].synchronize()
                device_ms["compress"] += ev[0].elapsed_time(ev[1])
                device_ms["decompress"] += ev[2].elapsed_time(ev[3])
                if rec["x_hat"].shape != x.shape:
                    raise AssertionError(f"apps: decoded {rec['x_hat'].shape}")
        counts = dict(gdn.LAUNCHES)
        counted = _abi_diff(before)
        traces = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        if len(traces) != 1:
            raise AssertionError(f"apps: device_trace wrote {traces}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        trace_mib = os.path.getsize(traces[0]) / 2**20
    if counts.pop("gdn_fwd") != 6 * len(images) or any(counts.values()):
        raise AssertionError(f"apps: launched {gdn.LAUNCHES}")
    _hold_abi("apps round trip", counted, 6, len(images))
    names = [e.get("name", "") for e in events]
    if APPS_ANNOTATION not in names:
        raise AssertionError("apps: the trace lacks the annotation")
    records = sum(1 for n in names if any(k in n for k in GDN_KERNELS))
    if not records:
        raise AssertionError("apps: the trace holds no GDN kernel record")
    report = timings.report()
    for name, dev in device_ms.items():
        wall = 1e3 * report[name]["total_s"]
        if report[name]["count"] != len(images) or not wall >= dev:
            raise AssertionError(f"apps: {name} wall {wall:.3f} ms, device "
                                 f"{dev:.3f} ms, {report[name]}")
    log(f"apps round trip ({SERVE_ARCH} q{QUALITY}, {len(images)} images "
        f"of {IMAGE[1]}x{IMAGE[2]}), ms: "
        + json.dumps({k: {"wall": round(1e3 * report[k]["total_s"], 3),
                          "device": round(v, 3)}
                      for k, v in device_ms.items()})
        + f"; timed compress ms {[round(1e3 * s, 2) for s in enc_s]}; "
        f"trace {trace_mib:.1f} MiB, {len(events)} events, {records} GDN "
        f"kernel records for {6 * len(images)} launches (records may be "
        f"lost; the C ABI's count is held)\n{timings}")
    return 6 * len(images)


def _step_times(step, state, batch, gen, n):
    """n steps' wall ms (host clock between synchronizes) and device-span
    ms (CUDA events recorded around each step: the span from the step's
    first device operation to its last, idle gaps included)."""
    import torch

    wall, span = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        step(state, batch, gen)
        end.record()
        end.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        span.append(start.elapsed_time(end))
    return wall, span


def _ablation_steps():
    """Part 2 of phase 16: GDN's share of phase 5's step, measured with
    `LMIC_ABLATE_GDN`. Returns the launch counts of the plain steps."""
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
    rows = {}
    for mode, dtype in (("f32", None), ("amp", torch.bfloat16)):
        module = zoo.create_model(TRAIN_ARCH, TRAIN_QUALITY, seed=0,
                                  device="cuda", dtype=dtype).module
        opt = make_optimizer()
        state = create_train_state(module, opt)
        step = make_train_step(module, opt, TRAIN_LAMBDA)
        gen = torch.Generator(device="cuda").manual_seed(0)
        for ablated in (False, True):
            if ablated:
                os.environ["LMIC_ABLATE_GDN"] = "1"
            try:
                _steps(step, state, batch, gen, 1)  # warm-up
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                _reset_counts()
                before = gdn.kernel_launches()
                wall, span = _step_times(step, state, batch, gen,
                                         ABLATION_TIMED)
                peak = torch.cuda.max_memory_allocated()
                gdn_ms, busy_ms, prof_wall, top, _ = _profile(
                    lambda: step(state, batch, gen))
                launched = dict(gdn.LAUNCHES)
                counted = _abi_diff(before)
            finally:
                os.environ.pop("LMIC_ABLATE_GDN", None)
            steps = ABLATION_TIMED + 3  # timed and profiled
            want = 0 if ablated else 6 * steps
            by_kernel = {k: sum(v for c, v in counted.items()
                                if c.startswith(k + "_")) for k in launched}
            if any(v != want for v in launched.values()) or \
                    any(v != want for v in by_kernel.values()):
                raise AssertionError(
                    f"{mode} ablated={ablated}: launched {launched}, by "
                    f"kernel {counted}; want {want} each")
            if not ablated:
                for k, v in launched.items():
                    counts[k] += v
            rows[(mode, ablated)] = {
                "wall_ms": float(np.median(wall)),
                "span_ms": float(np.median(span)), "busy_ms": busy_ms,
                "peak_gib": peak / 2**30}
            log(f"ablation {TRAIN_ARCH} q{TRAIN_QUALITY} {mode} "
                f"{'LMIC_ABLATE_GDN=1' if ablated else 'plain'}: wall ms "
                f"{json.dumps([round(v, 3) for v in wall])}, device span "
                f"ms (CUDA events) {json.dumps([round(v, 3) for v in span])}"
                f", peak {peak / 2**30:.3f} GiB; profile of 3 steps: device "
                f"busy {busy_ms:.3f} ms a step (GDN kernels {gdn_ms:.3f}), "
                f"wall {prof_wall:.3f}; largest kernels "
                + json.dumps({k: round(v, 3) for k, v in top.items()}))
        del module, state, opt, step
        torch.cuda.empty_cache()
        plain, ablated = rows[(mode, False)], rows[(mode, True)]
        log(f"GDN's share of the {mode} step, plain - ablated: "
            + ", ".join(
                f"{key[:-3]} {plain[key] - ablated[key]:.3f} of "
                f"{plain[key]:.3f} ms "
                f"({100 * (1 - ablated[key] / plain[key]):.1f} %)"
                for key in ("busy_ms", "span_ms", "wall_ms"))
            + f", peak {plain['peak_gib'] - ablated['peak_gib']:.3f} of "
            f"{plain['peak_gib']:.3f} GiB")
    return counts


def _apps_device_work():
    """Part 3 of phase 16: the apps' device work on the card against the
    CPU: video_bench's sequence metrics, bench_codecs' metrics, GDN1."""
    import torch

    from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence
    from lmic_tpu_torch.layers import GDN1
    from lmic_tpu_torch.utils import bench_codecs, profiling, video_bench

    T, H, W = APPS_CLIP
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, d, f"clip_{W}x{H}_30_yuv420.yuv")
                 for d in ("ref", "rec")]
        for p in paths:
            os.makedirs(os.path.dirname(p))
        _write_yuv_clip(paths[0], T, H, W, seed=16)
        raw = np.fromfile(paths[0], np.uint8)
        noise = np.random.default_rng(16).integers(-6, 7, raw.shape)
        np.clip(raw + noise, 0, 255).astype(np.uint8).tofile(paths[1])
        ref, rec = (RawVideoSequence.from_file(p) for p in paths)
        got = {}
        video_bench._sequence_metrics(ref, rec, device="cuda")  # warm-up
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[device] = video_bench._sequence_metrics(ref, rec,
                                                        device=device)
            ms = 1e3 * (time.perf_counter() - t0) / T
            log(f"video_bench sequence metrics on {device}, {T} frames of "
                f"{W}x{H}: {ms:.1f} ms a frame; "
                + json.dumps({k: round(v, 6) for k, v in got[device].items()}))
    for k, v in got["cpu"].items():
        bar = APPS_BARS["ms-ssim" if k.startswith("ms-ssim") else "psnr"]
        if not abs(got["cuda"][k] - v) < bar:
            raise AssertionError(f"video_bench {k}: card {got['cuda'][k]} "
                                 f"against CPU {v}")

    rng = np.random.default_rng(17)
    arr = rng.random(APPS_ARRAY, dtype=np.float32)
    rec_arr = np.clip(arr + rng.normal(0, 0.02, APPS_ARRAY), 0, 1).astype(
        np.float32)
    m = {d: bench_codecs._metrics_vs(arr, rec_arr, 12_345, 0.0, 0.0,
                                     device=d) for d in ("cuda", "cpu")}
    if m["cuda"]["bpp"] != m["cpu"]["bpp"] or not (
            abs(m["cuda"]["psnr"] - m["cpu"]["psnr"]) < APPS_BARS["psnr"]
            and abs(m["cuda"]["ms-ssim"] - m["cpu"]["ms-ssim"])
            < APPS_BARS["ms-ssim"]):
        raise AssertionError(f"bench_codecs metrics: {m}")
    log(f"bench_codecs metrics of a {APPS_ARRAY[1]}x{APPS_ARRAY[0]} pair, "
        f"card / CPU: " + json.dumps({d: {k: round(v, 7) for k, v in
                                          m[d].items()} for d in m}))

    worst = {}
    for inverse in (False, True):
        gen = torch.Generator().manual_seed(18 + inverse)
        layer = GDN1(GDN1_C, inverse=inverse)
        with torch.no_grad():
            layer.beta.add_(torch.rand(GDN1_C, generator=gen) * 0.5)
            layer.gamma.add_(torch.rand(GDN1_C, GDN1_C, generator=gen) * 0.1)
        x = torch.randn(GDN1_ROWS, GDN1_C, generator=gen)
        g = torch.randn(GDN1_ROWS, GDN1_C, generator=gen)
        outs = {}
        for device in ("cuda", "cpu"):
            layer.to(device).zero_grad()
            xd = x.detach().to(device).requires_grad_()  # a leaf on each
            timings = profiling.Timings()
            with timings.section("gdn1", sync=xd):
                y, s = profiling.timed(layer, xd)
                y.backward(g.to(device))
            outs[device] = [t.detach().cpu() for t in (
                y, xd.grad, layer.beta.grad, layer.gamma.grad)]
        for name, a, b in zip(("y", "dx", "dbeta", "dgamma"),
                              outs["cuda"], outs["cpu"]):
            err = ((a - b).abs().max() / max(1.0, b.abs().max())).item()
            worst[f"{'IGDN1' if inverse else 'GDN1'} {name}"] = err
            if not err < APPS_BARS["gdn1"]:
                raise AssertionError(f"GDN1 inverse={inverse} {name}: card "
                                     f"against CPU {err:.3g}")
    log(f"GDN1 at C = {GDN1_C} on {GDN1_ROWS} rows, card against CPU: "
        + json.dumps({k: float(f"{v:.3g}") for k, v in worst.items()}))
    log(f"video_bench X264().availability_error(): "
        f"{video_bench.X264().availability_error()!r}")


def phase_apps_and_ablation():
    """Phase 16 (see the module doc): the apps, profiling and the GDN
    ablation. Returns the launch counts of its main path: `gdn_fwd`'s on
    the apps' round trips, and each wrapper's in the plain steps of the
    ablation's A/B."""
    from lmic_tpu_torch import zoo
    from lmic_tpu_torch.ops import gdn

    t_phase = time.perf_counter()
    codec = zoo.create_model(SERVE_ARCH, QUALITY, seed=0, device="cuda")
    codec.update()
    images = _images(APPS_IMAGES)
    codec.decompress(**codec.compress(images[0]), u8=True)  # warm-up
    apps = _apps_round_trip(codec, images)
    training = _ablation_steps()
    # the switch is off again: one round trip launches the GDN as before
    _reset_counts()
    before = gdn.kernel_launches()
    codec.decompress(**codec.compress(images[0]), u8=True)
    if gdn.LAUNCHES["gdn_fwd"] != 6:
        raise AssertionError(f"after the ablation: launched {gdn.LAUNCHES}")
    _hold_abi("round trip after the ablation", _abi_diff(before), 6, 1)
    apps += 6
    _apps_device_work()
    log(f"apps and ablation phase: {time.perf_counter() - t_phase:.1f} s")
    return apps, training


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
            via = c.get("dx_kernel") or c.get("kernel")
            via = (f" ({via}" + (f", offset {c['offset']}" if "offset" in c
                                 else "") + ")") if via else ""
            log(f"{kernel} {c['shape']} {c['dtype']} inverse={c['inverse']}"
                f"{via}: "
                f"{c['us']:.1f} us (plain {c['plain_us']:.1f}, library "
                f"{c['library_us']:.1f}, bound {c['bound_us']:.1f} by "
                f"{c['bound_by']}), rel err {c['max_rel_err']:.2e}, abs err "
                f"{c['max_abs_err']:.3g}")
    layers = {k: _bf16_layers(cases, k) for k in ("gdn_fwd", "gdn_bwd_dx")}
    for kernel, by_layer in layers.items():
        for key, v in by_layer.items():
            log(f"bf16 {kernel} {key}: GDN / IGDN "
                + " / ".join(f"{u:.1f}" for u in v["us"])
                + f" us, bound {v['bound_us']:.1f} by {v['bound_by']} "
                f"({100 * v['bound_us'] / np.mean(v['us']):.0f} % of it), "
                "composite "
                + " / ".join(f"{u:.1f}" for u in v["library_us"]))
    # the bf16 forward and dx off the wide kernels' route (a view offset by
    # one element, C = 320): kernel, plain version, composite, bound
    off_route = {k: [{"shape": c["shape"], "inverse": c["inverse"],
                      **{m: round(c[m], 2) for m in (
                          "us", "plain_us", "library_us", "bound_us")}}
                     for c in cases[k]
                     if (c.get("kernel") or c.get("dx_kernel") or ""
                         ).endswith("_mma_kernel")]
                 for k in ("gdn_fwd", "gdn_bwd_dx")}
    for kernel, rows in off_route.items():
        log(f"bf16 {kernel} off the wide route: {json.dumps(rows)}")
    if args.kernels_only:
        log(json.dumps({"kernels_only": {
            kernel: {f"training_step_{d}": _totals(cases, kernel,
                                                   TRAIN_ROWS[:3], d)
                     for d in ("float32", "bfloat16")}
            for kernel in cases}, "bf16_fwd_by_layer": layers["gdn_fwd"],
            "bf16_dx_by_layer": layers["gdn_bwd_dx"]}))
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
    precision_launches, more_training["bf16_training"] = \
        phase_matmul_precision()
    more_training["data_parallel"] = phase_data_parallel()
    apps_launches, more_training["gdn_ablation"] = phase_apps_and_ablation()

    def totals(kernel, rows, dtype, C=192):
        return _totals(cases, kernel, rows, dtype, C)

    errors = {k: _max_abs_err_by_dtype(v) for k, v in cases.items()}
    # every training path: mbt2018-mean (phase 5), the AR family and the
    # RGB-T pair (phase 8), the paired `_R` arch (phase 9), --remat
    # (phase 13), --bf16 and --bf16 --remat (phase 14), DDP (phase 15), the
    # plain steps of the GDN ablation (phase 16)
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
        "cuda_kernels": CUDA_KERNELS["gdn_fwd"],
        "launches": (serve_launches + ar_launches + rgbt_launches
                     + paired_launches + eval_launches + pipe_launches
                     + pretrained_launches + precision_launches
                     + apps_launches + launched["gdn_fwd"]),
        "launches_by_path": {"serving": serve_launches,
                             "ar_serving": ar_launches,
                             "rgbt_serving": rgbt_launches,
                             "paired_serving": paired_launches,
                             "video_serving": video_launches,
                             "eval_and_files": eval_launches,
                             "pipelines_and_bundles": pipe_launches,
                             "pretrained_serving": pretrained_launches,
                             "matmul_precision": precision_launches,
                             "apps": apps_launches,
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
        "training_step_bf16_by_layer": layers["gdn_fwd"],
        "bf16_off_route": off_route["gdn_fwd"],
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
        "cuda_kernels": [k for name in gdn.BWD_KERNELS
                         for k in CUDA_KERNELS[name]],
        "launches": next(iter(bwd_counts.values())),
        "launches_by_kernel": bwd_counts,
        "launches_by_path": {"video_serving": video_launches,
                             "eval_and_files": 0,
                             "pipelines_and_bundles": 0,
                             "pretrained_serving": 0,
                             "matmul_precision": 0,
                             "apps": 0,
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
        "cuda_kernels": CUDA_KERNELS[name],
        "launches": launched[name],
        "launches_per_step": train_counts[name] / train_steps,
        "max_abs_err": max(errors[name].values()),
        "max_abs_err_by_dtype": errors[name],
        **totals(name, TRAIN_ROWS[:3], "float32"),
        "training_step_bf16": totals(name, TRAIN_ROWS[:3], "bfloat16"),
        **({"training_step_bf16_by_layer": layers[name],
            "bf16_off_route": off_route[name]} if name in layers else {}),
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
