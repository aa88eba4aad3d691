"""Traditional video-codec anchors over raw YUV sequences.

Counterpart of lmic_tpu/utils/video_bench.py (reference:
`compressai/utils/video/bench/{codecs.py,__main__.py}`): x264 / x265
through ffmpeg, and the VTM/HM reference software driven directly, with
lmic_tpu's command lines element for element. Each run encodes a raw
YUV420 sequence at a quality point, decodes it back, and reports PSNR
(Y/U/V/RGB), MS-SSIM and bitrate in the JSON schema of the learned-codec
eval, so `lmic-torch-plot` can overlay RD curves. The metrics run on
--device (CUDA by default).

Every codec degrades to a clear error when its binary is absent.

Usage:
  lmic-torch-video-bench clips/ -c x264 -q 23,28,33 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from lmic_tpu_torch import default_device
from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence
from lmic_tpu_torch.transforms.functional import ycbcr2rgb, yuv_420_to_444
from lmic_tpu_torch.utils.metrics import ms_ssim


class VideoCodec:
    """One traditional codec driven through ffmpeg; the metrics run on
    `device` (None: CUDA, `default_device`)."""

    name = "?"
    encoder_name = "?"

    def __init__(self, device=None):
        self.device = device

    def binary(self) -> str:
        return "ffmpeg"

    def available(self) -> bool:
        return self.availability_error() is None

    def encode_cmd(self, in_path: str, seq: RawVideoSequence,
                   quality: int, out_path: str) -> List[str]:
        fps = float(seq.framerate) if seq.framerate else 30.0
        return [
            self.binary(), "-y", "-f", "rawvideo",
            "-s", f"{seq.width}x{seq.height}",
            "-pix_fmt", "yuv420p", "-framerate", f"{fps:g}",
            "-i", in_path,
            "-c:v", self.encoder_name, "-crf", str(quality),
            "-preset", "medium", out_path,
        ]

    def decode_cmd(self, bitstream: str, out_yuv: str) -> List[str]:
        return [
            self.binary(), "-y", "-i", bitstream,
            "-pix_fmt", "yuv420p", out_yuv,
        ]

    def availability_error(self):
        """None when runnable, else a message naming the missing piece."""
        if shutil.which(self.binary()) is None:
            return f"{self.name}: '{self.binary()}' not found on PATH"
        return None

    def run(self, seq_path: str, quality: int) -> Dict[str, float]:
        err = self.availability_error()
        if err:
            raise RuntimeError(err)
        seq = RawVideoSequence.from_file(seq_path)
        with tempfile.TemporaryDirectory() as d:
            bitstream = os.path.join(d, f"out.{self.container()}")
            t0 = time.perf_counter()
            subprocess.run(
                self.encode_cmd(seq_path, seq, quality, bitstream),
                check=True, capture_output=True,
            )
            enc_time = time.perf_counter() - t0
            rec_yuv = os.path.join(
                d, f"rec_{seq.width}x{seq.height}_"
                   f"{seq.framerate}_yuv420.yuv"
            )
            t0 = time.perf_counter()
            subprocess.run(
                self.decode_cmd(bitstream, rec_yuv),
                check=True, capture_output=True,
            )
            dec_time = time.perf_counter() - t0
            size_bits = os.path.getsize(bitstream) * 8
            rec = RawVideoSequence.from_file(rec_yuv)
            metrics = _sequence_metrics(seq, rec, device=self.device)
        n = len(seq)
        fps = float(seq.framerate) if seq.framerate else 30.0
        metrics.update({
            "bitrate": size_bits * fps / n / 1000.0,  # kbps
            "encoding_time": enc_time,
            "decoding_time": dec_time,
        })
        return metrics

    def container(self) -> str:
        return "mp4"


class X264(VideoCodec):
    name = "x264"
    encoder_name = "libx264"


class X265(VideoCodec):
    name = "x265"
    encoder_name = "libx265"


class _RefVideoCodec(VideoCodec):
    """VTM/HM reference software driven directly on raw YUV420 sequences
    (reference utils/video/bench/codecs.py:206-335). Needs --build-dir
    (encoder/decoder apps) and --config; degrades to a clear availability
    error otherwise, like the ffmpeg codecs."""

    encoder_app = ""
    decoder_app = ""

    def __init__(self, build_dir: str = "", config: str = "", device=None):
        super().__init__(device)
        self.build_dir = build_dir
        self.config = config

    def binary(self) -> str:
        return os.path.join(self.build_dir, self.encoder_app)

    def availability_error(self):
        if not self.build_dir or not self.config:
            return f"{self.name}: --build-dir and --config are required"
        for app in (self.encoder_app, self.decoder_app):
            path = os.path.join(self.build_dir, app)
            if shutil.which(path) is None:
                return f"{self.name}: '{path}' not found or not executable"
        if not os.path.isfile(self.config):
            return f"{self.name}: config file '{self.config}' not found"
        return None

    def encode_cmd(self, in_path, seq, quality, out_path):
        fps = float(seq.framerate) if seq.framerate else 30.0
        return [
            self.binary(), "-i", in_path, "-c", self.config,
            "-q", str(quality), "-o", "/dev/null", "-b", out_path,
            "-wdt", str(seq.width), "-hgt", str(seq.height),
            "-fr", f"{fps:g}", "-f", str(len(seq)),
            "--InputBitDepth=8", "--OutputBitDepth=8",
        ]

    def decode_cmd(self, bitstream, out_yuv):
        return [
            os.path.join(self.build_dir, self.decoder_app),
            "-b", bitstream, "-o", out_yuv, "-d", "8",
        ]

    def container(self) -> str:
        return "bin"


class VTMVideo(_RefVideoCodec):
    name = "vtm"
    encoder_app = "EncoderAppStatic"
    decoder_app = "DecoderAppStatic"


class HMVideo(_RefVideoCodec):
    name = "hm"
    encoder_app = "TAppEncoderStatic"
    decoder_app = "TAppDecoderStatic"


VIDEO_CODEC_CLASSES = {"x264": X264, "x265": X265,
                       "vtm": VTMVideo, "hm": HMVideo}


def _sequence_metrics(ref: RawVideoSequence, rec: RawVideoSequence,
                      max_val: float = 255.0,
                      device=None) -> Dict[str, float]:
    """Reference metric semantics (utils/video/bench/__main__.py:135-223):
    per-frame MSEs are averaged over the sequence BEFORE the log; the RGB
    frame is bicubic-444-upsampled YCbCr converted through BT.709
    `ycbcr2rgb` and re-quantized to the bit-depth grid; MS-SSIM runs on
    those RGB frames; psnr-yuv is the 4:1:1-weighted plane average. The
    frames go to `device` and the sums run there in float64."""
    device = default_device(device)
    n = min(len(ref), len(rec))
    mse = {"y": 0.0, "u": 0.0, "v": 0.0, "rgb": 0.0}
    msssim = 0.0

    def planes(frame):
        return [
            torch.from_numpy(np.asarray(frame[c], np.float32)).to(device)[
                None, ..., None]
            for c in ("y", "u", "v")
        ]

    def to_rgb(p):
        x = ycbcr2rgb(yuv_420_to_444(p, mode="bicubic") / max_val)
        return torch.round(torch.clamp(x * max_val, 0.0, max_val))

    def mean_sq(a, b):
        return float(torch.mean((a.double() - b.double()) ** 2))

    for i in range(n):
        pa, pb = planes(ref[i]), planes(rec[i])
        for k, a, b in zip("yuv", pa, pb):
            mse[k] += mean_sq(a, b)
        ra, rb = to_rgb(pa), to_rgb(pb)
        mse["rgb"] += mean_sq(ra, rb)
        msssim += float(ms_ssim(ra, rb, max_val=max_val))

    def to_psnr(m):
        if m == 0.0:
            return float("inf")
        return float(20 * np.log10(max_val) - 10 * np.log10(m / n))

    out = {f"psnr-{k}": to_psnr(v) for k, v in mse.items()}
    out["psnr-yuv"] = (
        4 * out["psnr-y"] + out["psnr-u"] + out["psnr-v"]
    ) / 6
    out["ms-ssim-rgb"] = msssim / n
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description="traditional video codec bench")
    p.add_argument("dataset", help="directory of *_WxH_fps_yuv420.yuv files")
    p.add_argument("-c", "--codec", default="x264",
                   choices=sorted(VIDEO_CODEC_CLASSES))
    p.add_argument("-q", "--qualities", default="23,28,33,38",
                   help="comma-separated CRF/QP values")
    p.add_argument("-j", "--num-jobs", type=int, default=1,
                   help="parallel per-sequence workers")
    p.add_argument("--build-dir", default="",
                   help="VTM/HM binaries directory")
    p.add_argument("--config", default="", help="VTM/HM encoder config")
    p.add_argument("--output", default=None)
    p.add_argument("--device", default=None,
                   help="torch device of the metrics (default: CUDA; "
                        "raises without a GPU unless given)")
    return p.parse_args(argv)


def _make_codec(args) -> VideoCodec:
    cls = VIDEO_CODEC_CLASSES[args.codec]
    if issubclass(cls, _RefVideoCodec):
        return cls(args.build_dir, args.config, device=args.device)
    return cls(device=args.device)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    codec = _make_codec(args)
    err = codec.availability_error()
    if err:
        print(f"skipped: {err}", file=sys.stderr)
        return 1
    files = sorted(
        f for f in os.listdir(args.dataset) if f.endswith(".yuv")
    )
    results = []
    for q in (int(v) for v in args.qualities.split(",")):
        paths = [os.path.join(args.dataset, f) for f in files]
        if args.num_jobs > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=args.num_jobs) as pool:
                per_q = list(pool.map(lambda f: codec.run(f, q), paths))
        else:
            per_q = [codec.run(f, q) for f in paths]
        agg = {
            k: float(np.mean([m[k] for m in per_q])) for k in per_q[0]
        }
        agg["quality"] = q
        results.append(agg)
    blob = {"name": codec.name, "results": results}
    out = json.dumps(blob, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
