#!/usr/bin/env python3
"""On-card smoke run of lmic_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py        # from the root of a checkout, one NVIDIA GPU

Phases, each of which raises (exit code != 0) on any failure:

1. environment: the card's name and power limit, the torch/CUDA/nvcc
   versions; the port's native sources are built, all at once;
2. kernel: the CUDA GDN forward (`gdn_fwd`) against its plain version on
   the card at the main path's shapes, C in {128, 192}, f32 and bf16, both
   directions, with CUDA-event timings of the kernel, the plain version and
   the nearest PyTorch composite, beside the least time the card could take;
3. serving (the main path): mbt2018-mean at quality 8 (N=192, M=320) from a
   seed, served by the port's HTTP server; three seeded 512x768 uint8
   images go through POST /compress and /decompress with the launch counts
   set to 0 just before and read just after; then the decoded bytes are
   held to the direct codec calls, encoding to be deterministic, decoding
   to recover exactly the encoded latents, and the CUDA transforms to the
   CPU plain-version transforms on a small input;
4. the other archs: one direct round trip each of bmshj2018-factorized and
   bmshj2018-hyperprior at quality 8, 512x768.

The next-to-last line of stdout is the kernels' JSON summary; the last is
{"ok": true, "device": {...}}. Without a GPU, or run from a directory that
does not hold the port, it exits non-zero and prints no result.
"""

from __future__ import annotations

import http.client
import io
import json
import os
import subprocess
import sys
import threading
import time
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
KERNEL_SHAPES = [(n, C) for C in (128, 192)
                 for n in (98_304, 24_576, 6_144, 6_151)]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # as tests/test_pallas_gdn.py
IMAGE = (1, 512, 768, 3)  # Kodak geometry
SERVE_ARCH, QUALITY = "mbt2018-mean", 8


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
    sources = ("gdn_fwd.cu", "lmic_rans.cc")
    with ThreadPoolExecutor(len(sources)) as pool:  # one compiler each
        libs = list(pool.map(_build.build, sources))
    log(f"built {', '.join(sources)} in {time.perf_counter() - t0:.1f} s")
    with open(libs[0] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("ptxas:", line.strip())
    return smi


def _peaks(name):
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise RuntimeError(f"no published peaks for {name!r}")


def _time_ms(fn, runs=20, warmup=3):
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


def phase_kernel(peaks):
    import torch

    from lmic_tpu_torch.ops import gdn

    mem_bw, fp32, bf16 = peaks
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for n, C in KERNEL_SHAPES:
        for dtype in ("float32", "bfloat16"):
            dt = getattr(torch, dtype)
            x = torch.randn((n, C), generator=gen, device="cuda").to(dt)
            beta = (torch.rand(C, generator=gen, device="cuda") + 0.5).to(dt)
            gamma = (torch.rand((C, C), generator=gen, device="cuda") * 0.02
                     + 0.1 * torch.eye(C, device="cuda")).to(dt)
            gamma_t = gamma.t().contiguous()
            es = x.element_size()
            nbytes = (2 * n * C + C * C + C) * es
            ops = 2 * n * C * C + 4 * n * C
            t_mem, t_ops = nbytes / mem_bw, ops / (fp32 if es == 4 else bf16)
            for inverse in (False, True):
                got = gdn.gdn_fwd(x, beta, gamma, inverse)
                want = gdn.gdn_reference(x, beta, gamma, inverse)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                rel = err / max(1.0, want.float().abs().max().item())
                if not rel < TOL[dtype]:
                    raise AssertionError(
                        f"gdn_fwd {n}x{C} {dtype} inverse={inverse}: "
                        f"error {rel:.3g} >= {TOL[dtype]}"
                    )
                if not torch.equal(got, gdn.gdn_fwd(x, beta, gamma, inverse)):
                    raise AssertionError("gdn_fwd is not deterministic")
                rs = torch.sqrt if inverse else torch.rsqrt
                cases.append({
                    "impl": "cuda", "shape": [n, C], "dtype": dtype,
                    "inverse": inverse, "max_abs_err": err,
                    "max_rel_err": rel,
                    "us": 1e3 * _time_ms(
                        lambda: gdn.gdn_fwd(x, beta, gamma, inverse)),
                    "plain_us": 1e3 * _time_ms(
                        lambda: gdn.gdn_reference(x, beta, gamma, inverse)),
                    "library_us": 1e3 * _time_ms(
                        lambda: x * rs(torch.addmm(beta, x * x, gamma_t))),
                    "bound_us": 1e6 * max(t_mem, t_ops),
                    "bound_by": "operations" if t_ops > t_mem else "bytes",
                    "bytes_us": 1e6 * t_mem, "operations_us": 1e6 * t_ops,
                })
    return cases


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
            _, means = codec._params_from_zsym(z_sym)
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


def _cpu_agreement(arch, codec):
    """The CUDA transforms (GDN kernel, cuDNN without TF32) against the CPU
    plain-version transforms, same seed, on a small input: f32 sums in
    another order, so within 1e-4 of the largest value."""
    import torch

    from lmic_tpu_torch import zoo

    cpu = zoo.create_model(arch, QUALITY, seed=0, device="cpu")
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
    return worst


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
        gdn.LAUNCHES["gdn_fwd"] = 0
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
        launches = gdn.LAUNCHES["gdn_fwd"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    if launches != 6 * len(images):  # 3 GDN in g_a + 3 IGDN in g_s
        raise AssertionError(f"main path launched gdn_fwd {launches} times")
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
    worst = _cpu_agreement(SERVE_ARCH, codec)
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
        worst = _cpu_agreement(arch, codec)
        nbytes = sum(len(s) for g in out["strings"] for s in g)
        log(f"{arch} q{QUALITY}: {nbytes} bytes, compress "
            f"{1e3 * (t1 - t0):.1f} ms, decompress {1e3 * (t2 - t1):.1f} ms, "
            f"CUDA vs CPU transforms within {worst:.3g}")


def main():
    import torch

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
    from lmic_tpu_torch.utils.determinism import set_wire_determinism

    set_wire_determinism()
    smi = phase_environment()
    name = torch.cuda.get_device_name(0)
    cases = phase_kernel(_peaks(name))
    for c in cases:
        log(f"gdn_fwd {c['shape']} {c['dtype']} inverse={c['inverse']}: "
            f"{c['us']:.1f} us (plain {c['plain_us']:.1f}, composite "
            f"{c['library_us']:.1f}, bound {c['bound_us']:.1f} by "
            f"{c['bound_by']}), rel err {c['max_rel_err']:.2e}")
    launches = phase_serving()
    phase_other_archs()

    # the kernel's time for one q8 512x768 round trip: the main path's six
    # f32 launches at C=192 (3 GDN in g_a, 3 IGDN in g_s)
    main_path = [c for c in cases if c["dtype"] == "float32"
                 and c["shape"][1] == 192 and c["shape"][0] % 64 == 0]
    if len(main_path) != 6:
        raise AssertionError(f"{len(main_path)} main-path kernel cases")

    def total(key):
        return sum(c[key] for c in main_path) / 1e3

    kernels = [{
        "name": "gdn_fwd",
        "route": "cuda",
        "source": "lmic_tpu_torch/csrc/gdn_fwd.cu",
        "replaces": "lmic_tpu/ops/pallas_gdn.py:71",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": total("us"),
        "plain_ms": total("plain_us"),
        "bound_ms": total("bound_us"),
        "bound_by": ("operations" if total("operations_us")
                     >= total("bytes_us") else "bytes"),
        "library_ms": total("library_us"),
        "card": smi,
        "cases": cases,
    }]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
