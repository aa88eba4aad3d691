"""The `train` traffic kind: one trainer taking steps back to back
(a closed loop), through lmic_tpu_torch's `make_train_step` with
`create_train_state` and its `DualOptimizer`.

Set-up builds the train state from the seeded weights and drives it
through its first `check_steps` steps, on crops that all differ; those
steps warm up every shape of the window and are the ones the reference
follows. The same state then trains in the window. A step is a failed
operation when its GDN launches, by the C ABI's counts, are not one
forward, dx, partials and reduce launch a GDN layer.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import devtrace, launches, synth, weights, yardstick
from benchmark.reference import train as ref_train

B1 = 0.9


class Driver:
    def __init__(self, cell, seed: int, device, counts=launches.program_counts):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.counts = counts
        cfg, tr = cell.config, cell.traffic
        self.N, self.M = int(cfg["N"]), int(cfg["M"])
        self.B, self.crop = int(tr["batch"]), tuple(tr["crop"])
        self.checks = int(tr["check_steps"])
        self.opt = cfg["optimizer"]
        self.ref = cell.reference()
        self.sd = weights.make(self.ref.Model, self.N, self.M,
                               synth.torch_seed(seed, 10), self.device)
        pool = tr["pool"]
        self.pool = synth.image_pool(pool["images"], pool["height"],
                                     pool["width"], seed, self.device)
        self.sched = synth.crop_schedule(
            int(tr["schedule_steps"]), self.B, pool["images"],
            pool["height"], pool["width"], self.crop, seed)
        self.noise_seed = synth.torch_seed(seed, 11)
        with torch.device("meta"):
            meta = self.ref.Model(self.N, self.M)
        x = torch.empty((self.B, 3) + self.crop, device="meta")
        noises = [torch.empty(s, device="meta")
                  for s in meta.noise_shapes(self.B, *self.crop)]
        self.fwd_flops, self.gdn_layers = yardstick.layer_flops(
            meta, meta.train_forward, x, noises)

    def batch(self, i: int) -> torch.Tensor:
        """Step i's crops, (B, 3, h, w) float in [0, 1], channels_last."""
        h, w = self.crop
        rows = self.sched[i % len(self.sched)]
        x = torch.stack([self.pool[a, :, t:t + h, l:l + w]
                         for a, t, l in rows.tolist()])
        return (x.float() / 255).contiguous(memory_format=torch.channels_last)

    # -- the program ----------------------------------------------------------

    def _step(self, i, trace):
        with devtrace.span("batch_feed", trace):
            x = self.batch(i)
        before = self.counts()
        with devtrace.span("train_step", trace):
            self.state, m = self.step(self.state, x, self.gen)
        got = launches.by_class(launches.delta(before, self.counts()))
        n = len(self.gdn_layers)
        ok = got == {c: n for c in yardstick.GDN_COSTS}
        return m, ok

    def setup(self):
        """The program's train state and its first steps (the warm-up and
        the steps the reference follows)."""
        from lmic_tpu_torch import zoo
        from lmic_tpu_torch.utils import train

        cfg = self.cell.config
        codec = zoo.create_model(cfg["architecture"], int(cfg["quality"]),
                                 device=self.device, state_dict=self.sd,
                                 N=self.N, M=self.M)
        self.module = codec.module
        opt = train.make_optimizer(self.opt["lr"], self.opt["aux_lr"],
                                   self.opt["clip"])
        self.state = train.create_train_state(self.module, opt)
        self.step = train.make_train_step(self.module, opt,
                                          float(cfg["lambda"]))
        self.gen = torch.Generator(device=self.device).manual_seed(
            self.noise_seed)
        self.failed = 0
        losses, grads = [], None
        for i in range(self.checks):
            m, ok = self._step(i, False)
            self.failed += not ok
            losses.append(float(m["loss"]))
            if i == 0:
                grads = self._first_grads()
        params = {k: p.detach().clone()
                  for k, p in self.module.named_parameters()}
        self.prog = {"losses": losses, "grads": grads, "params": params}
        self._sync()

    def _first_grads(self):
        """The first step's gradients as the optimizers got them (after
        the clip), from their state: Adam's first moment over 1 - b1."""
        out = {}
        for k, p in self.module.named_parameters():
            st = self.state.main.state.get(p) or self.state.aux.state.get(p)
            out[k] = (st["exp_avg"] / (1 - B1)).clone() if st else \
                torch.zeros_like(p)
        return out

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def window(self, seconds: float, trace: bool):
        """Steps back to back for `seconds`: (end-to-end values, counters,
        trace summary or None)."""
        prof = devtrace.profiler() if trace else None
        before = self.counts()
        i = self.checks
        if prof is not None:
            prof.__enter__()
        try:
            with devtrace.span("window", trace):
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < seconds:
                    _, ok = self._step(i, trace)
                    self.failed += not ok
                    i += 1
                self._sync()
                t1 = time.perf_counter()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        summary = devtrace.reduce(prof) if prof is not None else None
        steps = i - self.checks
        self.attempted = self.checks + steps
        counters = {"steps": steps, "images": steps * self.B,
                    "fwd_flops": self.fwd_flops, "batch": self.B,
                    "gdn_layers": self.gdn_layers,
                    "gdn_launches": launches.delta(before, self.counts())}
        return ({"train_img_s": steps * self.B / (t1 - t0)}, counters,
                summary, t1 - t0)

    def release(self):
        del self.state, self.step, self.module
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------------

    def _follow(self, tf32=False, rows=None, alter=False):
        model = self.ref.Model(self.N, self.M).to(self.device)
        gen = torch.Generator(device=self.device).manual_seed(self.noise_seed)
        # a fault: rows < B leaves the rest of each batch out
        B = self.B if rows is None else rows
        batches = [self.batch(i)[:B] for i in range(self.checks)]
        noises = [[torch.rand(s, generator=gen, device=self.device)
                   for s in model.noise_shapes(B, *self.crop)]
                  for _ in range(self.checks)]
        if alter:  # a fault: one row of every batch altered
            batches = [torch.cat([1 - x[:1], x[1:]]) for x in batches]
        matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            return ref_train.follow(
                model, self.sd, batches, noises, float(self.cell.config["lambda"]),
                self.opt["lr"], self.opt["aux_lr"], self.opt["clip"])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = matmul
            torch.backends.cudnn.allow_tf32 = cudnn

    def verify(self):
        """The numbers compared: the program's first steps against the
        reference's."""
        ref = self._follow()
        return ref_train.readings(self.prog, ref, self.sd)

    def control(self, variant: str):
        """The numbers compared with the reference put in the program's
        place: `tf32` computes it with TF32 on; `half_batch` leaves half
        of each batch out (the mean over the rest); `altered` alters one
        row of each batch."""
        ref = self._follow()
        cand = {"tf32": lambda: self._follow(tf32=True),
                "half_batch": lambda: self._follow(rows=self.B // 2),
                "altered": lambda: self._follow(alter=True)}[variant]()
        return ref_train.readings(cand, ref, self.sd)
