"""The `codec` traffic kind: one caller coding batches of uint8 images to
strings and back through lmic_tpu_torch's pipelined API, one batch ahead
(a closed loop): `compress_async(i + 1)`, then batch i's finalizer (the
host rANS), then `decompress_async(i)`, then batch i - 1's pixels.

Batches are drawn from a seeded pool of images made at set-up: a ring of
`ring` batches, each 16 distinct images, built once so that the loop
does no host copies of its own. A batch is a failed operation when its
pixels do not come back at its shape, when its GDN forward launches (by
the C ABI's counts) are not one a GDN layer an image to encode and one a
layer a batch to decode, or when a call took the codec's plain path
(`stats` names a plain stage: `enc_device_ms`, `dec_params_ms`,
`dec_device_ms`).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import devtrace, launches, synth, weights, yardstick
from benchmark.reference import codec as ref_codec

PLAIN_STAGES = ("enc_device_ms", "dec_params_ms", "dec_device_ms")
RANS_STAGES = ("enc_rans_ms", "dec_z_rans_ms", "dec_y_rans_ms")
FETCH_STAGES = ("enc_fetch_ms", "dec_idx_fetch_ms", "dec_fetch_ms")


class Driver:
    def __init__(self, cell, seed: int, device, counts=launches.program_counts):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.counts = counts
        cfg, tr = cell.config, cell.traffic
        self.N, self.M = int(cfg["N"]), int(cfg["M"])
        self.B, self.H, self.W = int(tr["batch"]), int(tr["height"]), \
            int(tr["width"])
        self.ref = cell.reference()
        self.sd = weights.make(self.ref.Model, self.N, self.M,
                               synth.torch_seed(seed, 10), self.device)
        n_pool = int(tr["pool_images"])
        self.pool = synth.image_pool(n_pool, self.H, self.W, seed,
                                     self.device)
        pool = self.pool.permute(0, 2, 3, 1).contiguous().cpu().numpy()
        self.sched = synth.batch_schedule(int(tr["ring"]), self.B, n_pool,
                                          seed)
        self.ring = [np.ascontiguousarray(pool[idx]) for idx in self.sched]
        self.sample = int(tr["sample_batches"])
        with torch.device("meta"):
            meta = self.ref.Model(self.N, self.M)
        x = torch.empty((1, 3, self.H, self.W), device="meta")

        def round_trip(x):
            y, z = meta.analysis(x)
            meta.hyper_synthesis(z)   # to encode
            meta.hyper_synthesis(z)   # to decode
            meta.g_s(y)

        self.flops_per_image, gdns = yardstick.layer_flops(meta, round_trip, x)
        enc = [g for g in gdns if g[0] == "gdn"]
        dec = [g for g in gdns if g[0] == "igdn"]
        # per batch: the analysis runs image by image, the synthesis once
        self.gdn_layers = enc * self.B + [(k, C, rows * self.B)
                                          for k, C, rows in dec]
        self.fwd_per_batch = len(self.gdn_layers)

    # -- the program ----------------------------------------------------------

    def setup(self, warm: int = 3):
        from lmic_tpu_torch import zoo

        cfg = self.cell.config
        self.codec = zoo.create_model(cfg["architecture"],
                                      int(cfg["quality"]),
                                      device=self.device, state_dict=self.sd,
                                      N=self.N, M=self.M)
        self.codec.update()
        self.failed = 0
        self.warm = len(self._loop(warm, None, False))
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _call(self, name, trace, fn, *args):
        """fn(*args) under a span, with the stats of that call and its GDN
        launches: (result, stats, launches)."""
        self.codec.stats.clear()
        before = self.counts()
        with devtrace.span(name, trace):
            out = fn(*args)
        got = launches.by_class(launches.delta(before, self.counts()))
        return out, dict(self.codec.stats), got.get("gdn_fwd", 0)

    def _loop(self, n_batches, seconds, trace):
        """The pipelined loop over `n_batches` batches, or for `seconds`
        when given: a record per batch."""
        recs = []
        t0 = time.perf_counter()

        def more(i):
            if seconds is None:
                return i < n_batches
            return time.perf_counter() - t0 < seconds

        def start(i):
            x = self.ring[i % len(self.ring)]
            rec = {"ring": i % len(self.ring), "t0": time.perf_counter(),
                   "stats": {}, "fwd": 0, "ok": True}
            fin, st, n = self._call("compress_async", trace,
                                    self.codec.compress_async, x)
            rec["stats"].update(st)
            rec["fwd"] += n
            recs.append(rec)
            return fin

        pending, prev = start(0), None
        i = 0
        while True:
            nxt = start(i + 1) if more(i + 1) else None
            rec = recs[i]
            out, st, n = self._call("finalize", trace, pending)
            rec["stats"].update(st)
            rec["fwd"] += n
            rec["out"] = out
            dec, st, n = self._call("decompress_async", trace,
                                    self.codec.decompress_async,
                                    out["strings"], out["shape"])
            rec["stats"].update(st)
            rec["fwd"] += n
            if prev is not None:
                self._pixels(recs[i - 1], prev, trace)
            prev, pending = dec, nxt
            if nxt is None:
                break
            i += 1
        self._pixels(recs[i], prev, trace)
        return recs

    def _pixels(self, rec, fin, trace):
        out, st, n = self._call("pixels", trace, fin)
        rec["t1"] = time.perf_counter()
        rec["stats"].update(st)
        rec["fwd"] += n
        rec["x_hat"] = out["x_hat"]
        rec["ok"] = (tuple(out["x_hat"].shape) == (self.B, self.H, self.W, 3)
                     and rec["fwd"] == self.fwd_per_batch
                     and not any(k in rec["stats"] for k in PLAIN_STAGES))
        self.failed += not rec["ok"]

    def window(self, seconds: float, trace: bool):
        prof = devtrace.profiler() if trace else None
        before = self.counts()
        if prof is not None:
            prof.__enter__()
        try:
            with devtrace.span("window", trace):
                t0 = time.perf_counter()
                recs = self._loop(None, seconds, trace)
                self._sync()
                t1 = time.perf_counter()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        summary = devtrace.reduce(prof) if prof is not None else None
        self.recs = recs
        self.attempted = self.warm + len(recs)
        mpix = len(recs) * self.B * self.H * self.W / 1e6
        lat = [1e3 * (r["t1"] - r["t0"]) for r in recs]
        stage = {k: sum(r["stats"].get(k, 0.0) for r in recs)
                 for k in RANS_STAGES + FETCH_STAGES}
        counters = {"batches": len(recs), "images": len(recs) * self.B,
                    "mpix": mpix, "flops_per_image": self.flops_per_image,
                    "rans_ms": sum(stage[k] for k in RANS_STAGES),
                    "fetch_ms": sum(stage[k] for k in FETCH_STAGES),
                    "gdn_layers": self.gdn_layers,
                    "gdn_launches": launches.delta(before, self.counts())}
        e2e = {"codec_mpix_s": mpix / (t1 - t0),
               "codec_batch_p90_ms": yardstick.quantile(lat, 0.9)}
        return e2e, counters, summary, t1 - t0

    def release(self):
        """Keep the sampled batches' outputs, free the program."""
        r = synth.rng(self.seed, 4)
        done = [i for i, rec in enumerate(self.recs) if "x_hat" in rec]
        pick = sorted(r.choice(len(done), min(self.sample, len(done)),
                               replace=False))
        self.picked = [self.recs[done[j]] for j in pick]
        del self.codec, self.recs
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------------

    def _model(self):
        model = self.ref.Model(self.N, self.M).to(self.device)
        model.load_state_dict(self.sd)
        return model.eval()

    def _pixels_of(self, recs):
        idx = np.concatenate([self.sched[r["ring"]] for r in recs])
        return self.pool[torch.as_tensor(idx, device=self.device)]

    def verify(self):
        """The sampled batches' strings decoded and their pixels judged:
        the worst image's parts per million of differing symbols and of
        differing pixel values."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model = self._model()
        tables = ref_codec.Tables(model)
        recs = self.picked
        want = (self.B, self.H, self.W, 3)
        if not recs or any(len(r["out"]["strings"][k]) != self.B
                           or tuple(r["x_hat"].shape) != want
                           for r in recs for k in (0, 1)):
            # answers missing or of the wrong shape: nothing to judge
            return {"sym_ppm": float("inf"), "pix_ppm": float("inf")}
        strings = [sum((r["out"]["strings"][k] for r in recs), [])
                   for k in (0, 1)]
        x_hat = torch.as_tensor(np.concatenate([r["x_hat"] for r in recs]))
        got = ref_codec.decode_and_judge(
            model, tables, self._pixels_of(recs), strings,
            recs[0]["out"]["shape"], x_hat)
        return {"sym_ppm": max(got["sym_ppm"]), "pix_ppm": max(got["pix_ppm"])}

    def control(self, variant: str):
        """The reference in the program's place, computed with TF32 on
        (`tf32`), judged like the program on the ring's first
        `sample_batches` batches."""
        if variant != "tf32":
            raise ValueError(variant)
        model = self._model()
        tables = ref_codec.Tables(model)
        recs = [{"ring": i} for i in range(self.sample)]
        pixels = self._pixels_of(recs)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            z, y, x = ref_codec.reference_in_place(model, tables, pixels)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        got = ref_codec.judge(model, tables, pixels, z, y, x)
        return {"sym_ppm": max(got["sym_ppm"]), "pix_ppm": max(got["pix_ppm"])}
