"""The harness on the CPU at a tiny size: cells resolved by name from
files of their own, the result line, and the checks on the process."""

import hashlib
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from benchmark import core, run
from cpu_cells import REPO, PlainLaunches, tiny_root

CELLS = ["mbt2018-mean-q7.train-f32-b16",
         "mbt2018-mean-q7.codec-768x512-b16",
         "cheng2020-anchor-q6.train-f32-b16"]
SEED = str(2 ** 33 + 19)


def run_cell(root, cell, trace, monkeypatch, seconds="1"):
    """(result line as a dict, standard error's lines) of one CPU run."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", SEED, "--seconds",
                       seconds, "--trace", str(trace)], device="cpu",
                      counts=PlainLaunches(monkeypatch), root=root)
    assert rc == 0
    return (json.loads(out.getvalue().strip().splitlines()[-1]),
            err.getvalue().strip().splitlines())


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            path = os.path.join(d, f)
            out[path] = hashlib.sha256(open(path, "rb").read()).hexdigest()
    return out


def test_a_cell_mix_config_and_metric_from_new_files_only(tmp_path,
                                                          monkeypatch):
    root = tiny_root(tmp_path)
    before = _digests(root)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "mbt2018-mean-q7.json")) as f:
        config = json.load(f)
    config.update(name="mbt2018-mean-q6", quality=6, **{"lambda": 8192})
    with open(os.path.join(b, "configs", "mbt2018-mean-q6.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(b, "traffic", "train-f32-b3.json"), "w") as f:
        json.dump({"kind": "train", "batch": 3, "crop": [64, 64],
                   "pool": {"images": 9, "height": 96, "width": 128},
                   "schedule_steps": 16, "check_steps": 3}, f)
    cell = "mbt2018-mean-q6.train-f32-b3"
    with open(os.path.join(b, "limits", cell + ".json"), "w") as f:
        json.dump({"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}, f)
    with open(os.path.join(b, "metrics", "steps_per_s.py"), "w") as f:
        f.write("def read(run):\n"
                "    if run.kind != 'train':\n"
                "        return None\n"
                "    return run.counters['steps'] / run.window_s\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "mbt2018-mean-q6", "source": "x",
                             "file": "benchmark/configs/mbt2018-mean-q6.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "mbt2018-mean-q6",
                               "traffic": "train-f32-b3", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append(cell)
    bench["per_layer"].append({"name": "steps_per_s", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "model step", "moves": "train_img_s",
                               "workloads": [cell]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    resolved = core.Cell(root, cell)
    assert resolved.config["quality"] == 6 and resolved.traffic["batch"] == 3
    assert [m["name"] for m in resolved.per_layer] == ["steps_per_s"]
    line, _ = run_cell(root, cell, 1, monkeypatch)
    assert line["correct"] and line["metrics"]["steps_per_s"]["value"] > 0
    line, _ = run_cell(root, cell, 0, monkeypatch)
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_the_last_line(cell, trace, tmp_path, monkeypatch):
    root = tiny_root(tmp_path)
    line, err = run_cell(root, cell, trace, monkeypatch)
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    cellobj = core.Cell(root, cell)
    if trace == 0:
        assert set(line["metrics"]) == {m["name"]
                                        for m in cellobj.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    else:  # no device trace on the CPU: only the readers of counters
        assert set(line["metrics"]) <= {m["name"] for m in cellobj.per_layer}
    names = list(line["checks"])
    assert names == list(cellobj.limits)
    assert [e.split()[0] for e in err[-len(names):]] == names
    for e, (name, c) in zip(err[-len(names):], line["checks"].items()):
        assert e == f"{name} {c['value']!r} limit {c['limit']!r}"


def test_banned_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lmic_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert not {"lmic_tpu_torch", "jaxtyping"} & set(core.banned_modules())
    monkeypatch.setitem(sys.modules, "lmic_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "flax.core", object())
    assert {"lmic_tpu", "flax"} <= set(core.banned_modules())


def test_a_run_loads_no_jax(tmp_path):
    root = tiny_root(tmp_path)
    code = (
        "import sys, pytest\n"
        f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'benchmark', 'tests')!r}]\n"
        "from cpu_cells import PlainLaunches\n"
        "from benchmark import core, run\n"
        "mp = pytest.MonkeyPatch()\n"
        f"run.main(['--workload', {CELLS[1]!r}, '--seed', '5', '--seconds', "
        f"'1'], device='cpu', counts=PlainLaunches(mp), root={root!r})\n"
        "print('BANNED', core.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "BANNED []"


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    argv = ["benchmark/run.py", "--workload", CELLS[0], "--seed", "1",
            "--seconds", "1"]
    out = subprocess.run([sys.executable] + argv, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    root = tiny_root(tmp_path)  # BENCHMARK.json and benchmark/ alone
    out = subprocess.run([sys.executable] + argv, cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
