"""The port's host apps against lmic_tpu's on the CPU: `utils/profiling.py`,
`utils/bench_codecs.py`, `utils/find_close.py`, `utils/plot_cli.py` and
`utils/video_bench.py`, on lmic_tpu's own fixtures (a 176x176 image,
64x64 clips):

- the Pillow codecs: bpp equal (the same bytes), psnr within 1e-4 dB and
  ms-ssim within 1e-5 of lmic_tpu's (the port sums in f64; lmic_tpu's f32
  MS-SSIM is up to 3.0e-6 off, ROADMAP C); `collect` serial against 4
  threads; the bisection's quality and bpp;
- every reference encoder's command lines element for element, from each
  package's own `run` with the subprocess recorded (no binary is here);
- `load_series` on the same files, the plots' series, and the `--ssim-db`
  conversion; a PNG under Agg; plotly through a recording stand-in;
- `_sequence_metrics` on a 3-frame pair within the same bars;
- each new module imports where PIL, matplotlib, plotly, msgpack and jax
  cannot be imported (the card's machine has none of them for sure)."""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import types

import numpy as np
import pytest
import torch
from PIL import Image

from lmic_tpu.datasets.rawvideo import RawVideoSequence as JSeq
from lmic_tpu.utils import bench_codecs as jbench
from lmic_tpu.utils import find_close as jfind
from lmic_tpu.utils import plot_cli as jplot
from lmic_tpu.utils import video_bench as jvideo
from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence as TSeq
from lmic_tpu_torch.utils import bench_codecs as tbench
from lmic_tpu_torch.utils import find_close as tfind
from lmic_tpu_torch.utils import plot_cli as tplot
from lmic_tpu_torch.utils import profiling
from lmic_tpu_torch.utils import video_bench as tvideo

ROOT = pathlib.Path(__file__).resolve().parents[1]
PSNR_DB = 1e-4
MS_SSIM = 1e-5


@pytest.fixture(scope="module")
def img_path(tmp_path_factory):
    """lmic_tpu's fixture (tests/test_cli_tools.py): low-frequency content,
    so JPEG quality spans a bpp range."""
    d = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(0)
    base = rng.random((8, 8, 3))
    arr = np.kron(base, np.ones((24, 24, 1)))[:176, :176]
    path = d / "img.png"
    Image.fromarray((arr * 255).astype(np.uint8)).save(path)
    return str(path)


def _match(got, want):
    assert list(got) == list(want)
    assert got["bpp"] == want["bpp"]
    assert abs(got["psnr"] - want["psnr"]) < PSNR_DB
    assert abs(got["ms-ssim"] - want["ms-ssim"]) < MS_SSIM


@pytest.mark.parametrize("name,quality", [("jpeg", 50), ("webp", 50),
                                          ("jpeg2000", 20)])
def test_pillow_codecs_match_lmic_tpu(img_path, name, quality):
    want = jbench.CODECS[name]().run(img_path, quality)
    got = tbench.CODECS[name](device="cpu").run(img_path, quality)
    _match(got, want)


def test_collect_fanout_matches_serial(img_path):
    jpeg = tbench.JPEG(device="cpu")
    serial = tbench.collect(jpeg, [img_path], [30, 70], num_jobs=1)
    threaded = tbench.collect(jpeg, [img_path], [30, 70], num_jobs=4)
    assert serial["bpp"] == threaded["bpp"] and len(serial["bpp"]) == 2
    # f64 sums, split by the calling thread's intra-op thread count
    for k in ("psnr", "ms-ssim"):
        np.testing.assert_allclose(threaded[k], serial[k], rtol=1e-12)
    assert serial["bpp"][1] > serial["bpp"][0]


@pytest.mark.parametrize("name", ["jpeg", "webp"])
def test_find_closest_matches_lmic_tpu(img_path, name):
    want = jfind.find_closest(name, img_path, 0.5, "bpp")
    got = tfind.find_closest(name, img_path, 0.5, "bpp", device="cpu")
    assert got[0] == want[0]
    _match(got[1], want[1])


@pytest.fixture
def tools(tmp_path, monkeypatch):
    """Stand-ins for every reference binary (on PATH for BPG), a config,
    a tfci.py, and a fixed temporary directory for both packages' runs."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name in ("EncoderAppStatic", "DecoderAppStatic",
                 "TAppEncoderStatic", "TAppDecoderStatic", "aomenc",
                 "aomdec", "bpgenc", "bpgdec"):
        p = bin_dir / name
        p.write_text("#!/bin/sh\n")
        p.chmod(0o755)
    (tmp_path / "intra.cfg").write_text("# cfg\n")
    (tmp_path / "tfci.py").write_text("")
    monkeypatch.setenv("PATH", f"{bin_dir}:{os.environ.get('PATH', '')}")
    work = tmp_path / "work"
    work.mkdir()

    class FixedDir:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return str(work)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(tempfile, "TemporaryDirectory", FixedDir)
    return tmp_path, bin_dir


def _commands(module, run, monkeypatch):
    """The command lines a codec's `run` hands to subprocess.run, which
    records them and does nothing (so reading the output fails after)."""
    calls = []
    monkeypatch.setattr(module.subprocess, "run",
                        lambda cmd, **kw: calls.append(list(cmd)))
    with pytest.raises((FileNotFoundError, OSError, ValueError)):
        run()
    return calls


def _codec_pairs(tmp_path, bin_dir):
    cfg, b = str(tmp_path / "intra.cfg"), str(bin_dir)
    tfci = str(tmp_path / "tfci.py")
    return {
        "bpg": (lambda m: m.BPG(), 30),
        "tfci": (lambda m: m.TFCI(tfci, "mbt2018-mean-mse"), 4),
        "vtm": (lambda m: m.VTM(b, cfg), 32),
        "vtm_rgb": (lambda m: m.VTM(b, cfg, rgb=True), 37),
        "hm": (lambda m: m.HM(b, cfg), 27),
        "hm_rgb": (lambda m: m.HM(b, cfg, rgb=True), 22),
        "av1": (lambda m: m.AV1(b), 40),
    }


@pytest.mark.parametrize("which", ["bpg", "tfci", "vtm", "vtm_rgb", "hm",
                                   "hm_rgb", "av1"])
def test_reference_encoder_commands_match_lmic_tpu(tools, img_path, which,
                                                   monkeypatch):
    tmp_path, bin_dir = tools
    make, quality = _codec_pairs(tmp_path, bin_dir)[which]
    want = _commands(jbench, lambda: make(jbench).run(img_path, quality),
                     monkeypatch)
    got = _commands(tbench, lambda: make(tbench).run(img_path, quality),
                    monkeypatch)
    assert len(want) == 2 and got == want


def test_quality_ranges_and_missing_tools(tmp_path):
    cfg = tmp_path / "intra.cfg"
    cfg.write_text("# cfg\n")
    for cls in (tbench.VTM, tbench.HM):
        with pytest.raises(RuntimeError, match="binaries not found"):
            cls(str(tmp_path), str(cfg))
    with pytest.raises(RuntimeError, match="binaries not found"):
        tbench.AV1(str(tmp_path))
    with pytest.raises(RuntimeError, match="tfci.py"):
        tbench.TFCI(str(tmp_path / "missing_tfci.py"))


def test_quality_checks(tools):
    tmp_path, bin_dir = tools
    cfg = str(tmp_path / "intra.cfg")
    with pytest.raises(ValueError, match="Invalid quality"):
        tbench.VTM(str(bin_dir), cfg)._enc_cmd("in.yuv", 99, "o", 8, 8)
    with pytest.raises(ValueError, match="Invalid quality"):
        tbench.HM(str(bin_dir), cfg)._enc_cmd("in.yuv", 52, "o", 8, 8)
    with pytest.raises(ValueError, match="Invalid quality"):
        tbench.AV1(str(bin_dir))._enc_cmd("in.yuv", 64, "o", 8, 8)
    with pytest.raises(ValueError, match="Invalid quality"):
        tbench.TFCI(str(tmp_path / "tfci.py"))._enc_cmd("a.png", 9, "o")


def test_bench_main_skips_cleanly(tmp_path, capsys):
    rc = tbench.main(["vtm", "-d", str(tmp_path), "-q", "32",
                      "--build-dir", str(tmp_path),
                      "--config", str(tmp_path / "nope.cfg")])
    assert rc == 1
    assert "skipped" in capsys.readouterr().err


def test_bench_main_writes_lmic_tpus_layout(img_path, tmp_path, capsys):
    d = pathlib.Path(img_path).parent
    out = tmp_path / "r.json"
    assert tbench.main(["jpeg", "-d", str(d), "-q", "40", "80",
                        "--output", str(out), "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    assert doc["name"] == "JPEG" and len(doc["results"]["bpp"]) == 2
    # lmic_tpu's plot reads it
    assert jplot.load_series(str(out), "psnr")[0][0] == "JPEG"


# --- plot_cli


def _result_files(tmp_path):
    """An eval JSON with several entries (one point each, two archs), a
    reference-style file with arrays, and the video-bench list layout."""
    evals = [{"name": "mbt2018-mean", "results": {"bpp": b, "psnr": p,
                                                  "ms-ssim": s}}
             for b, p, s in ((0.4, 31.0, 0.96), (0.2, 28.5, 0.93),
                             (0.8, 34.0, 0.985))]
    evals.append({"name": "bmshj2018", "results": {
        "bpp": [0.1, 0.3], "psnr": [26.0, 30.0], "ms-ssim": [0.9, 0.95]}})
    evals.append({"name": "broken", "results": {"bpp": None, "psnr": 1}})
    video = {"name": "x264", "results": [
        {"quality": 28, "bitrate": 900.0, "psnr-yuv": 33.0,
         "ms-ssim-rgb": 0.97},
        {"quality": 23, "bitrate": 2000.0, "psnr-yuv": 36.0,
         "ms-ssim-rgb": 0.985}]}
    paths = []
    for name, doc in (("eval.json", evals), ("video.json", video)):
        p = tmp_path / name
        p.write_text(json.dumps(doc))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("metric,rate", [("psnr", "bpp"),
                                         ("ms_ssim", "bpp"),
                                         ("psnr-yuv", "bitrate"),
                                         ("ms-ssim-rgb", "bitrate")])
def test_load_series_matches_lmic_tpu(tmp_path, metric, rate):
    for path in _result_files(tmp_path):
        got = tplot.load_series(path, metric, rate)
        assert got == jplot.load_series(path, metric, rate)
    assert tplot.load_series(_result_files(tmp_path)[0], "psnr")[0] == (
        "mbt2018-mean", [0.2, 0.4, 0.8], [28.5, 31.0, 34.0])


def _fake_plotly(monkeypatch):
    """A recording stand-in for the part of plotly that the plot CLI uses
    (tests/test_cli_tools.py's pattern: plotly is not installed here)."""
    calls = {}

    class FakeScatter:
        def __init__(self, x=None, y=None, name=None):
            calls.setdefault("scatters", []).append((name, x, y))

    class FakeFigure:
        def add_traces(self, t):
            pass

        def update_xaxes(self, **kw):
            calls["xlabel"] = kw.get("title_text")

        def update_yaxes(self, **kw):
            calls["ylabel"] = kw.get("title_text")

        def update_layout(self, **kw):
            calls["title"] = kw.get("title")

    go = types.ModuleType("plotly.graph_objs")
    go.Figure, go.Scatter = FakeFigure, FakeScatter
    pio = types.ModuleType("plotly.io")

    def write_html(fig, file=None, auto_open=False):
        calls["file"] = file
        with open(file, "w") as f:
            f.write("<html></html>")

    pio.write_html = write_html
    monkeypatch.setitem(sys.modules, "plotly", types.ModuleType("plotly"))
    monkeypatch.setitem(sys.modules, "plotly.graph_objs", go)
    monkeypatch.setitem(sys.modules, "plotly.io", pio)
    return calls


@pytest.mark.parametrize("argv", [
    ["--metric", "psnr"],
    ["--metric", "ms-ssim", "--ssim-db", "-t", "dB"],
    ["--metric", "psnr-yuv", "--rate", "bitrate"],
], ids=["psnr", "ssim-db", "video"])
def test_plotly_series_match_lmic_tpu(tmp_path, monkeypatch, argv):
    files = _result_files(tmp_path)
    seen = []
    for plot in (jplot, tplot):
        calls = _fake_plotly(monkeypatch)
        out = tmp_path / f"{plot.__name__}.html"
        plot.main(["-f", *files, "--backend", "plotly", "-o", str(out),
                   *argv])
        assert out.exists()
        seen.append(calls)
    assert seen[1] == {**seen[0], "file": seen[1]["file"]}
    assert seen[1]["scatters"]


def test_plotly_absent_raises_lmic_tpus_message(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "plotly", None)
    with pytest.raises(SystemExit, match="Unable to import plotly"):
        tplot.main(["-f", _result_files(tmp_path)[0], "--backend",
                    "plotly"])


def test_matplotlib_png(tmp_path):
    out = tmp_path / "rd.png"
    assert tplot.main(["-f", *_result_files(tmp_path), "-o", str(out)]) == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


# --- video_bench


def _clip(path, W=64, H=64, T=3, seed=0, noise=None):
    rng = np.random.default_rng(seed)
    n = T * (H * W + 2 * (H // 2) * (W // 2))
    raw = rng.integers(0, 256, n, dtype=np.uint8)
    if noise is not None:
        raw = np.clip(raw + np.random.default_rng(noise).integers(
            -6, 7, n), 0, 255).astype(np.uint8)
    raw.tofile(path)
    return str(path)


def test_sequence_metrics_match_lmic_tpu(tmp_path):
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ref = _clip(tmp_path / "a" / "clip_64x64_30_yuv420.yuv")
    rec = _clip(tmp_path / "b" / "clip_64x64_30_yuv420.yuv", noise=1)
    want = jvideo._sequence_metrics(JSeq.from_file(ref), JSeq.from_file(rec))
    got = tvideo._sequence_metrics(TSeq.from_file(ref), TSeq.from_file(rec),
                                   device="cpu")
    assert list(got) == list(want)
    for k, v in want.items():
        bar = MS_SSIM if k == "ms-ssim-rgb" else PSNR_DB
        assert abs(got[k] - v) < bar, k
    same = tvideo._sequence_metrics(TSeq.from_file(ref), TSeq.from_file(ref),
                                    device="cpu")
    assert all(same[f"psnr-{k}"] == float("inf") for k in
               ("y", "u", "v", "rgb", "yuv"))
    assert same["ms-ssim-rgb"] == pytest.approx(1.0, abs=1e-12)


def test_video_codec_commands_match_lmic_tpu(tools):
    tmp_path, bin_dir = tools
    path = _clip(tmp_path / "clip_64x64_30_yuv420.yuv", T=2)
    cfg = str(tmp_path / "intra.cfg")
    tseq, jseq = TSeq.from_file(path), JSeq.from_file(path)
    # lmic_tpu takes the framerate from the path's first digits (a fault
    # the port's reader fixed, ROADMAP C): give its sequence the port's
    assert tseq.framerate == 30
    jseq.framerate = tseq.framerate
    for name, cls in tvideo.VIDEO_CODEC_CLASSES.items():
        jcls = jvideo.VIDEO_CODEC_CLASSES[name]
        if name in ("vtm", "hm"):
            t, j = cls(str(bin_dir), cfg), jcls(str(bin_dir), cfg)
            assert t.available()
        else:
            t, j = cls(), jcls()
        assert t.encode_cmd(path, tseq, 32, "out.bin") == \
            j.encode_cmd(path, jseq, 32, "out.bin")
        assert t.decode_cmd("out.bin", "rec.yuv") == \
            j.decode_cmd("out.bin", "rec.yuv")
        assert t.container() == j.container()
    assert tvideo.HMVideo("", "").availability_error() == \
        jvideo.HMVideo("", "").availability_error()


def test_video_missing_binary_errors_cleanly(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tvideo.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="ffmpeg"):
        tvideo.X264().run(str(tmp_path / "x_64x64_30_yuv420.yuv"), 23)
    assert tvideo.main([str(tmp_path), "-c", "x265"]) == 1
    assert "skipped" in capsys.readouterr().err


# --- profiling


def test_timings_and_timed():
    """lmic_tpu's TestProfiling (tests/test_utils.py) on port tensors."""
    t = profiling.Timings()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    with t.section("b", sync={"x": [torch.ones(4)], "y": (1, "s")}):
        pass
    rep = t.report()
    assert rep["a"]["count"] == 2 and rep["b"]["count"] == 1
    assert "a" in str(t) and rep["b"]["mean_s"] >= 0

    out, dt = profiling.timed(torch.sum, torch.ones(16))
    assert float(out) == 16.0 and dt >= 0


def test_device_trace_writes_the_annotation(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (trace,) = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "port_region" in names


# --- optional packages


def test_new_modules_import_without_optional_packages(tmp_path):
    """Each new module imports, the metrics and availability errors work,
    and a Pillow path fails with an ImportError, where PIL, matplotlib,
    plotly, msgpack and jax cannot be imported."""
    code = f"""
import sys
for name in ("PIL", "matplotlib", "plotly", "msgpack", "jax", "jaxlib",
             "flax", "lmic_tpu"):
    sys.modules[name] = None
import numpy as np
from lmic_tpu_torch.layers import GDN1
from lmic_tpu_torch.utils import (bench_codecs, checkpoint, find_close,
                                  plot_cli, profiling, video_bench)
a = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
m = bench_codecs._metrics_vs(a, a, 10, 0.0, 0.0, device="cpu")
assert m["psnr"] == float("inf") and m["bpp"] == 10 * 8 / 64 ** 2
assert video_bench.X264().availability_error() is None or "ffmpeg" in \\
    video_bench.X264().availability_error()
try:
    bench_codecs.JPEG(device="cpu").run({str(tmp_path / "x.png")!r}, 50)
except ImportError:
    pass
else:
    raise AssertionError("PIL was importable")
try:
    checkpoint._msgpack_restore(b"\\x80")
except ImportError as e:
    assert "msgpack" in str(e)
else:
    raise AssertionError("msgpack was importable")
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
