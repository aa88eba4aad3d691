"""The harness's frame: a cell resolved by name from BENCHMARK.json and the
files it names, the checks on the machine and on the process, the
per-layer readers, and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by name:

- configs: the `file` of the configuration's entry in BENCHMARK.json;
  its `reference` key names `benchmark/reference/<reference>.py`;
- traffic: `benchmark/traffic/<traffic>.json`, whose `kind` names the
  driver `benchmark/drivers/<kind>.py`;
- limits of the comparison that decides `correct`:
  `benchmark/limits/<workload>.json`;
- per-layer metrics: `benchmark/metrics/<metric>.py`, a `read(run)` that
  returns a number or None.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BANNED = ("jax", "jaxlib", "flax", "lmic_tpu")


def process_age_s() -> float:
    """Seconds since this process started (from /proc), or 0 where the
    system does not say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Clock:
    """Set-up time: from the process's start to the first timed
    operation."""

    def __init__(self):
        self.t0 = time.perf_counter() - process_age_s()

    def since_start(self) -> float:
        return time.perf_counter() - self.t0


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, root: str, name: str):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        self.chips = int(self.workload["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = self._json(entry["file"])
        self.traffic = self._json(os.path.join(
            "benchmark", "traffic", self.workload["traffic"] + ".json"))
        self.limits = self._json(os.path.join(
            "benchmark", "limits", name + ".json"))
        self.kind = self.traffic["kind"]
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        names = {m["name"] for m in self.end_to_end}
        # a metric with `workloads` is read in those cells; one without,
        # in every cell that reports the end-to-end metric it moves
        self.per_layer = [
            m for m in self.bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]

    def _json(self, rel: str) -> Dict:
        with open(os.path.join(self.root, rel)) as f:
            return json.load(f)

    def reference(self):
        """The configuration's plain reference module."""
        return importlib.import_module(
            "benchmark.reference." + self.config["reference"])

    def driver(self):
        return importlib.import_module("benchmark.drivers." + self.kind)

    def reader(self, metric: str):
        path = os.path.join(self.root, "benchmark", "metrics", metric + ".py")
        return _load_file(path, "benchmark_metric_" + metric.replace(".", "_")
                          .replace("-", "_"))


def require_devices(chips: int):
    """Exit (code 2, no result) without CUDA or with fewer cards than the
    cell asks for."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"benchmark: needs {chips} CUDA device(s), found "
                         f"{have}\n")
        sys.exit(2)


def banned_modules() -> List[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or
    lmic_tpu (compared whole: lmic_tpu_torch is none of them)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(BANNED))


def require_no_jax():
    found = banned_modules()
    if found:
        sys.stderr.write(f"benchmark: the process loaded {found}\n")
        sys.exit(3)


def read_per_layer(cell: Cell, run) -> Dict[str, Dict]:
    """Each per-layer metric of the cell whose reader finds something."""
    out = {}
    for m in cell.per_layer:
        value = cell.reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def check_entries(readings: Dict[str, float], limits: Dict[str, float]):
    """[(name, value, limit)] of every number compared, and whether each
    is within its limit (value <= limit)."""
    entries = [(k, float(readings[k]), float(limits[k])) for k in limits]
    return entries, all(v <= lim for _, v, lim in entries)


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict,
                device: Dict, checks, breakdown: Optional[Dict]) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return json.dumps(out)
