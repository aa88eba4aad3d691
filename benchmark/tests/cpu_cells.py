"""Tiny copies of the benchmark's cells for the CPU tests: the same
drivers, reference and readers, at widths and sizes a test run holds."""

from __future__ import annotations

import json
import os
import shutil
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {
    "mbt2018-mean-q7": {"N": 16, "M": 24},
    "cheng2020-anchor-q6": {"N": 16, "M": 16},
}
TRAIN = {"batch": 2, "crop": [64, 64],
         "pool": {"images": 6, "height": 128, "width": 192},
         "schedule_steps": 64}
CODEC = {"batch": 2, "height": 128, "width": 192, "pool_images": 4,
         "ring": 2, "sample_batches": 2}


def tiny_root(tmp) -> str:
    """A copy of BENCHMARK.json and benchmark/ under `tmp` whose
    configurations and traffic are cut to CPU size and whose limits are
    loose (the tests that judge a comparison set their own)."""
    root = str(tmp)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    _add_pending(root)
    b = os.path.join(root, "benchmark")
    for name, widths in TINY.items():
        edit(os.path.join(b, "configs", name + ".json"), widths)
    for name in os.listdir(os.path.join(b, "traffic")):
        path = os.path.join(b, "traffic", name)
        with open(path) as f:
            kind = json.load(f)["kind"]
        edit(path, TRAIN if kind == "train" else CODEC)
    return root


# cells whose files are in benchmark/ and that BENCHMARK.json may not
# list yet: the CPU tests add them to their copy, so that every driver,
# configuration and limit file stays tested
PENDING = {
    "configs": [{"name": "cheng2020-anchor-q6", "source": "x",
                 "file": "benchmark/configs/cheng2020-anchor-q6.json",
                 "reduced": [], "why": "x"}],
    "workloads": [
        {"name": "mbt2018-mean-q7.codec-768x512-b16",
         "config": "mbt2018-mean-q7", "traffic": "codec-768x512-b16",
         "chips": 1, "why": "x"},
        {"name": "cheng2020-anchor-q6.train-f32-b16",
         "config": "cheng2020-anchor-q6", "traffic": "train-f32-b16",
         "chips": 1, "why": "x"}],
    "end_to_end": [
        {"name": "codec_mpix_s", "unit": "Mpix/s", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["mbt2018-mean-q7.codec-768x512-b16"]},
        {"name": "codec_batch_p90_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["mbt2018-mean-q7.codec-768x512-b16"]}],
    "per_layer": [
        {"name": n, "unit": u, "better": b, "source": "device_trace",
         "layer": "x", "moves": "codec_mpix_s",
         "workloads": ["mbt2018-mean-q7.codec-768x512-b16"]}
        for n, u, b in (("codec_mfu_pct", "%", "higher"),
                        ("device_idle_pct.codec", "%", "lower"),
                        ("gdn_roofline.codec", "%", "higher"),
                        ("rans_ms_per_mpix", "ms/Mpix", "lower"),
                        ("fetch_wait_ms_per_mpix", "ms/Mpix", "lower"))],
}


def _add_pending(root):
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for key, entries in PENDING.items():
        have = {e["name"] for e in bench[key]}
        bench[key] += [e for e in entries if e["name"] not in have]
    cheng = "cheng2020-anchor-q6.train-f32-b16"
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("moves", m["name"]) == "train_img_s" and \
                cheng not in m.get("workloads", [cheng]):
            m["workloads"].append(cheng)
    with open(path, "w") as f:
        json.dump(bench, f)


def edit(path, changes):
    with open(path) as f:
        data = json.load(f)
    data.update(changes)
    with open(path, "w") as f:
        json.dump(data, f)


class PlainLaunches:
    """Counts the port's plain GDN calls on the CPU under the names of the
    CUDA kernels that stand for them on the card."""

    NAMES = {"gdn_reference": "gdn_fwd_kernel"}
    BWD = ("gdn_bwd_dx_kernel", "gdn_bwd_partials_kernel",
           "gdn_bwd_reduce_kernel")

    def __init__(self, monkeypatch):
        from lmic_tpu_torch.ops import gdn

        self.n = Counter()
        fwd, bwd = gdn.gdn_reference, gdn.gdn_bwd_reference

        def counted_fwd(*a, **k):
            self.n["gdn_fwd_kernel"] += 1
            return fwd(*a, **k)

        def counted_bwd(*a, **k):
            for name in self.BWD:
                self.n[name] += 1
            return bwd(*a, **k)

        monkeypatch.setattr(gdn, "gdn_reference", counted_fwd)
        monkeypatch.setattr(gdn, "gdn_bwd_reference", counted_bwd)

    def __call__(self):
        return dict(self.n)
