"""Traditional-codec benchmark harness (reference:
compressai/utils/bench/codecs.py:149-962 + __main__.py).

Counterpart of lmic_tpu/utils/bench_codecs.py: the `Codec` ABC with the
Pillow-backed anchors (JPEG, WebP, JPEG2000) and the subprocess-backed
reference encoders (BPG, TFCI, VTM, HM, AV1), with lmic_tpu's command
lines element for element. An absent tool raises a clear availability
error at construction time, as the reference does when its binaries are
missing; the command construction stays testable without them.

PSNR and MS-SSIM run through `utils/metrics.py` (float64 sums) on the
codec's device: CUDA unless `device=` (`--device`) says otherwise. Pillow
is imported where an image is read or coded, so the module, `_metrics_vs`,
`collect` and the availability errors work on a host without it.

The (quality x image) grid fans out over a thread pool (`--num-jobs`,
reference __main__.py:62-113 uses multiprocessing.Pool): the hot work is
in external subprocesses and GIL-releasing Pillow coders.

Usage:
  lmic-torch-bench jpeg -d /path/images -q 20 50 80 [--device cpu]
  lmic-torch-bench vtm -d kodak/ -q 22 27 32 37 \
      --build-dir /path/vtm/bin --config encoder_intra_vtm.cfg
"""

from __future__ import annotations

import argparse
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from lmic_tpu_torch import default_device
from lmic_tpu_torch.transforms.functional import rgb2ycbcr, ycbcr2rgb
from lmic_tpu_torch.utils.metrics import ms_ssim, psnr


def _read_rgb(path) -> np.ndarray:
    """An image file as (H, W, 3) float32 in [0, 1]."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _metrics_vs(arr: np.ndarray, rec_arr: np.ndarray, nbytes: int,
                enc_time: float, dec_time: float,
                device=None) -> Dict[str, float]:
    """The bench's metric dict of a reconstruction `rec_arr` of `arr`
    ((H, W, 3) in [0, 1]) coded in `nbytes`, the sums on `device`."""
    device = default_device(device)
    a = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    r = torch.from_numpy(np.ascontiguousarray(rec_arr)).to(device)
    num_pixels = arr.shape[0] * arr.shape[1]
    return {
        "psnr": float(psnr(r, a)),
        "ms-ssim": float(ms_ssim(r[None], a[None])),
        "bpp": nbytes * 8.0 / num_pixels,
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


class Codec:
    """One traditional codec: run(img_path, quality) -> metrics dict."""

    fmt: str = ""

    def __init__(self, device=None):
        self.device = device  # of the metrics; None: CUDA (default_device)

    def name(self) -> str:
        raise NotImplementedError

    def run(self, img_path: str, quality: int) -> Dict[str, float]:
        from PIL import Image

        img = Image.open(img_path).convert("RGB")
        arr = np.asarray(img, np.float32) / 255.0
        t0 = time.perf_counter()
        data = self._encode(img, quality)
        enc_time = time.perf_counter() - t0
        t0 = time.perf_counter()
        rec = self._decode(data)
        dec_time = time.perf_counter() - t0
        rec_arr = np.asarray(rec.convert("RGB"), np.float32) / 255.0
        return _metrics_vs(arr, rec_arr, len(data), enc_time, dec_time,
                           self.device)

    def _encode(self, img, quality: int) -> bytes:
        buf = io.BytesIO()
        img.save(buf, format=self.fmt, quality=quality)
        return buf.getvalue()

    def _decode(self, data: bytes):
        from PIL import Image

        return Image.open(io.BytesIO(data))


class JPEG(Codec):
    fmt = "JPEG"

    def name(self):
        return "JPEG"


class WebP(Codec):
    fmt = "WEBP"

    def name(self):
        return "WebP"


class JPEG2000(Codec):
    fmt = "JPEG2000"

    def name(self):
        return "JPEG2000"

    def _encode(self, img, quality):
        buf = io.BytesIO()
        # Pillow J2K: quality via quality_layers (compression ratios)
        img.save(buf, format="JPEG2000", quality_mode="rates",
                 quality_layers=[quality])
        return buf.getvalue()


class _BinaryCodec(Codec):
    """Subprocess-backed codec; checks its binaries exist (reference gates
    BPG/VTM/HM/AV1 on installed encoders)."""

    binaries: List[str] = []

    def __init__(self, device=None):
        missing = [b for b in self.binaries if shutil.which(b) is None]
        if missing:
            raise RuntimeError(
                f"{self.name()} requires binaries not found on PATH: "
                f"{missing}"
            )
        super().__init__(device)


class BPG(_BinaryCodec):
    binaries = ["bpgenc", "bpgdec"]

    def name(self):
        return "BPG"

    def run(self, img_path, quality):  # pragma: no cover - needs bpg tools
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            out = Path(d) / "out.bpg"
            rec = Path(d) / "rec.png"
            t0 = time.perf_counter()
            subprocess.run(
                ["bpgenc", "-q", str(quality), "-o", str(out), img_path],
                check=True,
            )
            enc_time = time.perf_counter() - t0
            t0 = time.perf_counter()
            subprocess.run(["bpgdec", "-o", str(rec), str(out)], check=True)
            dec_time = time.perf_counter() - t0
            return _metrics_vs(_read_rgb(img_path), _read_rgb(rec),
                               out.stat().st_size, enc_time, dec_time,
                               self.device)


class TFCI(_BinaryCodec):
    """tensorflow/compression `tfci.py` models (reference codecs.py:483-540):
    encode/decode by shelling out to the tfci script."""

    models = [
        "bmshj2018-factorized-mse",
        "bmshj2018-hyperprior-mse",
        "mbt2018-mean-mse",
    ]

    def __init__(self, tfci_path: str = "tfci.py",
                 model: str = "bmshj2018-factorized-mse", device=None):
        self.tfci_path = tfci_path
        self.model = model
        if not Path(tfci_path).is_file():
            raise RuntimeError(
                f"TFCI requires the tfci.py script (got {tfci_path!r}); "
                "clone tensorflow/compression and pass --tfci-path"
            )
        if model not in self.models:
            raise ValueError(f"unknown TFCI model {model!r}")
        super().__init__(device)

    def name(self):
        return self.model

    def _enc_cmd(self, img_path, quality, out_path):
        if not 1 <= quality <= 8:
            raise ValueError(f"Invalid quality value: {quality} (1, 8)")
        return [sys.executable, self.tfci_path, "compress",
                f"{self.model}-{quality:d}", img_path, out_path]

    def _dec_cmd(self, bin_path, png_path):
        return [sys.executable, self.tfci_path, "decompress", bin_path,
                png_path]

    def run(self, img_path, quality):  # pragma: no cover - needs tfci
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            out = Path(d) / "out.tfci"
            rec_png = Path(d) / "out.tfci.png"
            enc_cmd = self._enc_cmd(img_path, quality, str(out))
            t0 = time.perf_counter()
            subprocess.run(enc_cmd, check=True, capture_output=True)
            enc_time = time.perf_counter() - t0
            t0 = time.perf_counter()
            subprocess.run(self._dec_cmd(str(out), str(rec_png)),
                           check=True, capture_output=True)
            dec_time = time.perf_counter() - t0
            return _metrics_vs(_read_rgb(img_path), _read_rgb(rec_png),
                               out.stat().st_size, enc_time, dec_time,
                               self.device)


def _to_planar_444(rgb: np.ndarray, ycc: bool) -> np.ndarray:
    """(H, W, 3) RGB in [0, 1] -> (3, H, W) uint8, through BT.709 YCbCr
    when `ycc`."""
    if ycc:
        rgb = np.clip(rgb2ycbcr(torch.from_numpy(rgb)).numpy(), 0, 1)
    return np.round(rgb * 255).astype(np.uint8).transpose(2, 0, 1)


def _from_planar_444(planar: np.ndarray, ycc: bool) -> np.ndarray:
    """Inverse of `_to_planar_444`: (3, H, W) uint8 -> (H, W, 3) RGB."""
    rec = planar.transpose(1, 2, 0).astype(np.float32) / 255.0
    if ycc:
        rec = np.clip(ycbcr2rgb(torch.from_numpy(rec)).numpy(), 0, 1)
    return rec


class _YuvRefCodec(_BinaryCodec):
    """Shared VTM/HM flow (reference codecs.py:596-837): PNG -> planar
    YCbCr444 uint8 -> reference encoder/decoder -> back through ycbcr2rgb,
    metrics against the original RGB."""

    qp_range = (0, 63)

    def __init__(self, build_dir: str, config: str, rgb: bool = False,
                 device=None):
        self.encoder_path = str(Path(build_dir) / self.encoder_name)
        self.decoder_path = str(Path(build_dir) / self.decoder_name)
        self.config_path = config
        self.rgb = rgb
        self.binaries = [self.encoder_path, self.decoder_path]
        super().__init__(device)
        if not Path(config).is_file():
            raise RuntimeError(f"{self.name()}: config file not found: "
                               f"{config}")

    encoder_name = ""
    decoder_name = ""
    extra_enc_flags: List[str] = []

    def _enc_cmd(self, yuv_path, quality, out_path, width, height):
        lo, hi = self.qp_range
        if not lo <= quality <= hi:
            raise ValueError(
                f"Invalid quality value: {quality} ({lo},{hi})"
            )
        cmd = [
            self.encoder_path, "-i", yuv_path, "-c", self.config_path,
            "-q", str(quality), "-o", "/dev/null", "-b", out_path,
            "-wdt", str(width), "-hgt", str(height), "-fr", "1", "-f", "1",
            "--InputChromaFormat=444", "--InputBitDepth=8",
        ] + list(self.extra_enc_flags)
        if self.rgb:
            cmd += [
                "--InputColourSpaceConvert=RGBtoGBR",
                "--SNRInternalColourSpace=1",
                "--OutputInternalColourSpace=0",
            ]
        return cmd

    def _dec_cmd(self, bin_path, yuv_path):
        cmd = [self.decoder_path, "-b", bin_path, "-o", yuv_path, "-d", "8"]
        if self.rgb:
            cmd.append("--OutputInternalColourSpace=GBRtoRGB")
        return cmd

    def run(self, img_path, quality):  # pragma: no cover - needs binaries
        import tempfile

        rgb = _read_rgb(img_path)
        H, W = rgb.shape[:2]
        planar = _to_planar_444(rgb, ycc=not self.rgb)
        with tempfile.TemporaryDirectory() as d:
            yuv = Path(d) / "in.yuv"
            out = Path(d) / "out.bin"
            rec_yuv = Path(d) / "rec.yuv"
            yuv.write_bytes(planar.tobytes())
            t0 = time.perf_counter()
            subprocess.run(
                self._enc_cmd(str(yuv), quality, str(out), W, H),
                check=True, capture_output=True,
            )
            enc_time = time.perf_counter() - t0
            t0 = time.perf_counter()
            subprocess.run(
                self._dec_cmd(str(out), str(rec_yuv)),
                check=True, capture_output=True,
            )
            dec_time = time.perf_counter() - t0
            rec_planar = np.fromfile(rec_yuv, np.uint8).reshape(3, H, W)
            nbytes = out.stat().st_size
        rec = _from_planar_444(rec_planar, ycc=not self.rgb)
        return _metrics_vs(rgb, rec, nbytes, enc_time, dec_time,
                           self.device)


class VTM(_YuvRefCodec):
    """VVC reference software (EncoderApp/DecoderApp)."""

    encoder_name = "EncoderAppStatic"
    decoder_name = "DecoderAppStatic"
    extra_enc_flags = ["--ConformanceWindowMode=1"]

    def name(self):
        return "VTM"


class HM(_YuvRefCodec):
    """H.265/HEVC reference software (TAppEncoder/TAppDecoder)."""

    encoder_name = "TAppEncoderStatic"
    decoder_name = "TAppDecoderStatic"
    qp_range = (0, 51)
    extra_enc_flags = [
        "--SEIDecodedPictureHash", "--Level=5.1",
        "--CUNoSplitIntraACT=0", "--ConformanceMode=1",
    ]

    def name(self):
        return "HM"


class AV1(_BinaryCodec):
    """AOM reference software (aomenc/aomdec), YCbCr444 path
    (reference codecs.py:839-962)."""

    def __init__(self, build_dir: str, device=None):
        self.encoder_path = str(Path(build_dir) / "aomenc")
        self.decoder_path = str(Path(build_dir) / "aomdec")
        self.binaries = [self.encoder_path, self.decoder_path]
        super().__init__(device)

    def name(self):
        return "AV1"

    def _enc_cmd(self, yuv_path, quality, out_path, width, height):
        if not 0 <= quality <= 63:
            raise ValueError(f"Invalid quality value: {quality} (0,63)")
        return [
            self.encoder_path, "-w", str(width), "-h", str(height),
            "--fps=1/1", "--limit=1", "--input-bit-depth=8",
            "--cpu-used=0", "--threads=1", "--passes=2",
            "--end-usage=q", f"--cq-level={quality}", "--i444",
            "--skip=0", "--tune=psnr", "--psnr", "--bit-depth=8",
            "-o", out_path, yuv_path,
        ]

    def _dec_cmd(self, bin_path, yuv_path):
        return [self.decoder_path, bin_path, "-o", yuv_path,
                "--rawvideo", "--output-bit-depth=8"]

    def run(self, img_path, quality):  # pragma: no cover - needs aom
        import tempfile

        rgb = _read_rgb(img_path)
        H, W = rgb.shape[:2]
        planar = _to_planar_444(rgb, ycc=True)
        with tempfile.TemporaryDirectory() as d:
            yuv = Path(d) / "in.yuv"
            out = Path(d) / "out.webm"
            rec_yuv = Path(d) / "rec.yuv"
            enc_cmd = self._enc_cmd(str(yuv), quality, str(out), W, H)
            yuv.write_bytes(planar.tobytes())
            t0 = time.perf_counter()
            subprocess.run(enc_cmd, check=True, capture_output=True)
            enc_time = time.perf_counter() - t0
            t0 = time.perf_counter()
            subprocess.run(self._dec_cmd(str(out), str(rec_yuv)),
                           check=True, capture_output=True)
            dec_time = time.perf_counter() - t0
            rec_planar = np.fromfile(rec_yuv, np.uint8).reshape(3, H, W)
            nbytes = out.stat().st_size
        rec = _from_planar_444(rec_planar, ycc=True)
        return _metrics_vs(rgb, rec, nbytes, enc_time, dec_time,
                           self.device)


CODECS = {
    "jpeg": JPEG, "webp": WebP, "jpeg2000": JPEG2000, "bpg": BPG,
    "tfci": TFCI, "vtm": VTM, "hm": HM, "av1": AV1,
}


def _build_codec(args) -> Codec:
    """Construct the selected codec, passing through the binary-codec
    options it needs; availability errors surface here with a clear
    message (the reference fails the same way when tools are absent)."""
    name, device = args.codec, args.device
    if name in ("vtm", "hm"):
        if not args.build_dir or not args.config:
            raise SystemExit(
                f"{name}: --build-dir and --config are required"
            )
        return CODECS[name](args.build_dir, args.config, rgb=args.rgb,
                            device=device)
    if name == "av1":
        if not args.build_dir:
            raise SystemExit("av1: --build-dir is required")
        return CODECS[name](args.build_dir, device=device)
    if name == "tfci":
        return CODECS[name](args.tfci_path, args.model, device=device)
    return CODECS[name](device=device)


def collect(codec: Codec, files, qualities, num_jobs: int = 1):
    """Fan the (quality x image) grid out over a thread pool and average
    per quality (reference __main__.py:62-113)."""
    grid = [(qi, str(f)) for qi, _ in enumerate(qualities) for f in files]

    def one(item):
        qi, f = item
        return qi, codec.run(f, qualities[qi])

    if num_jobs > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=num_jobs) as pool:
            rv = list(pool.map(one, grid))
    else:
        rv = [one(g) for g in grid]

    per_q: Dict[str, List[float]] = {}
    for qi, _ in enumerate(qualities):
        ms = [m for i, m in rv if i == qi]
        for k in ms[0]:
            per_q.setdefault(k, []).append(
                float(np.mean([m[k] for m in ms]))
            )
    return per_q


def main(argv=None):
    p = argparse.ArgumentParser(description="traditional codec bench")
    p.add_argument("codec", choices=sorted(CODECS))
    p.add_argument("-d", "--dataset", required=True)
    p.add_argument("-q", "--qualities", type=int, nargs="+",
                   default=[10, 30, 50, 70, 90])
    p.add_argument("-j", "--num-jobs", type=int, default=1,
                   help="parallel (quality x image) workers")
    p.add_argument("--output", default=None)
    # binary-codec options (reference setup_args per codec)
    p.add_argument("--build-dir", default=None,
                   help="VTM/HM/AV1 binaries directory")
    p.add_argument("--config", default=None, help="VTM/HM encoder config")
    p.add_argument("--rgb", action="store_true",
                   help="VTM/HM: RGB internal colour space (over YCbCr)")
    p.add_argument("--tfci-path", default="tfci.py",
                   help="path to tensorflow/compression tfci.py")
    p.add_argument("--model", default="bmshj2018-factorized-mse",
                   choices=TFCI.models, help="TFCI model")
    p.add_argument("--device", default=None,
                   help="torch device of the metrics (default: CUDA; "
                        "raises without a GPU unless given)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])

    try:
        codec = _build_codec(args)
    except RuntimeError as e:
        print(f"skipped: {e}", file=sys.stderr)
        return 1
    files = sorted(
        f for f in Path(args.dataset).iterdir()
        if f.suffix.lower() in {".png", ".jpg", ".jpeg"}
    )
    per_q = collect(codec, files, args.qualities, args.num_jobs)
    for i, q in enumerate(args.qualities):
        print(f"q={q}: " + " ".join(
            f"{k}={v[i]:.4f}" for k, v in per_q.items()
        ), flush=True)
    results = {"name": codec.name(), "results": per_q}
    print(json.dumps(results, indent=2))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
