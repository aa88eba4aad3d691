"""ssf2020 video evaluation CLI (reference:
compressai/utils/video/eval_model/__main__.py:244-568).

Counterpart of lmic_tpu/utils/video_eval.py. Per raw YUV sequence:
YUV420 -> RGB444 (bicubic chroma upsampling as `jax.image.resize` does it,
then BT.709), centred padding to a multiple of 2^7, whole GOPs through
`ScaleSpaceFlowCodec`, and the reference's metric set per frame:

- psnr-y / psnr-u / psnr-v in the 420 domain on rounded [0, 2^bitdepth-1]
  integers (the reconstruction RGB -> YCbCr -> 2x2 average pool, against
  the ORIGINAL planes, :141-160), psnr-yuv = (4 y + u + v) / 6;
- psnr-rgb / mse-rgb on rounded [0, max_val] values and ms-ssim-rgb, all
  against the bicubic-upsampled original (:162-173);
- bitrate in kbps: coded bytes with the real coder, the likelihoods'
  estimate with --entropy-estimation (:176-183, 303).

Output follows the reference schema (:359-399, :545-568): one JSON per
sequence ({stem}-{trained_net}.json: source, name, description,
results), and a cumulative {arch}-{metric}-{description}.json whose
result arrays gain one entry per run.

Usage:
  lmic-torch-video-eval -d /path/to/yuvs --gop 12 --checkpoint ssf.ckpt \
      -o out/ [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from lmic_tpu_torch.datasets.rawvideo import RawVideoSequence, VideoFormat
from lmic_tpu_torch.transforms import (
    rgb2ycbcr,
    ycbcr2rgb,
    yuv_420_to_444,
    yuv_444_to_420,
)
from lmic_tpu_torch.utils.metrics import ms_ssim

PAD_MULTIPLE = 2**7


def yuv420_frame_to_rgb(frame, bitdepth: int = 8,
                        device=None) -> torch.Tensor:
    """Structured (y, u, v) record -> (1, H, W, 3) float32 RGB on
    `device`."""
    max_val = 2**bitdepth - 1

    def plane(name):
        p = torch.from_numpy(np.asarray(frame[name], np.float32))
        return (p.to(device) / max_val)[None, :, :, None]

    yuv = yuv_420_to_444((plane("y"), plane("u"), plane("v")),
                         mode="bicubic")
    return ycbcr2rgb(yuv)


def pad_frames(x: torch.Tensor, p: int = PAD_MULTIPLE):
    """Centred zero padding of (N, H, W, C) to a multiple of p (reference
    __main__.py:119-139, codec_rgbt.py:279-293), so bitstreams stay
    file-compatible with the reference codec app.

    Returns (padded, padding) with padding = (left, right, top, bottom).
    """
    H, W = x.shape[1:3]
    nh, nw = -(-H // p) * p, -(-W // p) * p
    left = (nw - W) // 2
    top = (nh - H) // 2
    padding = (left, nw - W - left, top, nh - H - top)
    return F.pad(x, (0, 0, *padding)), padding


def crop_frames(x, padding: Tuple[int, int, int, int]):
    """Inverse of pad_frames on (..., H, W, C)."""
    left, right, top, bottom = padding
    H, W = x.shape[-3], x.shape[-2]
    return x[..., top:H - bottom or None, left:W - right or None, :]


def _psnr(mse: float, max_val: int) -> float:
    return 20 * math.log10(max_val) - 10 * math.log10(max(mse, 1e-12))


def compute_metrics_for_frame(org_frame, rec_rgb: torch.Tensor,
                              bitdepth: int = 8) -> Dict[str, float]:
    """The reference's metric set for ONE frame (__main__.py:141-175).

    org_frame: the raw YUV420 record; rec_rgb: (1, H, W, 3) float in
    [0, 1], already cropped to the original geometry; the sums run on its
    device.
    """
    max_val = 2**bitdepth - 1
    device = rec_rgb.device
    out: Dict[str, float] = {}

    # YUV metrics in the 420 domain on rounded integer values
    rec = torch.clamp(rec_rgb, 0.0, 1.0)
    for comp, plane in zip("yuv", yuv_444_to_420(rgb2ycbcr(rec))):
        org = torch.from_numpy(np.asarray(org_frame[comp], np.float32))
        rec_p = torch.round(torch.clamp(plane[0, :, :, 0] * max_val, 0,
                                        max_val))
        mse = float(torch.mean((org.to(device).double()
                                - rec_p.double()) ** 2))
        out[f"psnr-{comp}"] = _psnr(mse, max_val)
    out["psnr-yuv"] = (4 * out["psnr-y"] + out["psnr-u"] + out["psnr-v"]) / 6

    # RGB metrics against the bicubic-upsampled original, on rounded values
    org_rgb = torch.round(torch.clamp(
        yuv420_frame_to_rgb(org_frame, bitdepth, device) * max_val, 0,
        max_val))
    rec_255 = torch.round(rec * max_val)
    mse_rgb = float(torch.mean((org_rgb.double() - rec_255.double()) ** 2))
    out["mse-rgb"] = mse_rgb
    out["psnr-rgb"] = _psnr(mse_rgb, max_val)
    out["ms-ssim-rgb"] = float(ms_ssim(org_rgb / max_val, rec_255 / max_val))
    return out


def _iter_strings(obj):
    if isinstance(obj, bytes):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _iter_strings(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _iter_strings(v)


def _estimated_bits(likelihoods) -> float:
    """-log2 of a GOP's likelihoods: per frame {sub-codec: {"y", "z"}}."""
    return sum(float(-torch.sum(torch.log2(part)))
               for lk in likelihoods for sub in lk.values()
               for part in sub.values())


@torch.inference_mode()
def eval_sequence(codec, seq: RawVideoSequence, gop: int = 12,
                  max_frames: Optional[int] = None,
                  entropy_estimation: bool = False) -> Dict[str, float]:
    """One sequence, whole GOPs at a time, on the codec's device."""
    n = len(seq) if max_frames is None else min(len(seq), max_frames)
    metrics: Dict[str, List[float]] = defaultdict(list)
    total_bytes = 0
    est_bits = 0.0
    enc_time = dec_time = 0.0
    device = codec.device

    for start in range(0, n, gop):
        idxs = range(start, min(start + gop, n))
        frames = torch.cat([yuv420_frame_to_rgb(seq[i], seq.bitdepth, device)
                            for i in idxs])  # (T, H, W, 3)
        padded, padding = pad_frames(frames)
        if entropy_estimation:
            # (1, T, 3, H, W), each frame channels_last, as codec._frames
            out = codec.module(padded[None].permute(0, 1, 4, 2, 3),
                               training=False)
            rec = out["x_hat"].permute(0, 1, 3, 4, 2)
            est_bits += _estimated_bits(out["likelihoods"])
        else:
            clip = padded[None].cpu().numpy()
            t0 = time.perf_counter()
            strings, shapes = codec.compress(clip)
            enc_time += time.perf_counter() - t0
            t0 = time.perf_counter()
            rec = torch.from_numpy(codec.decompress(strings, shapes)).to(
                device)
            dec_time += time.perf_counter() - t0
            total_bytes += sum(len(s) for s in _iter_strings(strings))
        rec = torch.clamp(crop_frames(rec, padding), 0, 1)

        for t, i in enumerate(idxs):
            m = compute_metrics_for_frame(seq[i], rec[0, t][None],
                                          seq.bitdepth)
            for k, v in m.items():
                metrics[k].append(v)

    fps = float(seq.framerate) if seq.framerate else 30.0
    out = {k: float(np.mean(v)) for k, v in metrics.items()}
    # mean bits a frame * fps -> kbps (reference :345-349)
    bits = est_bits if entropy_estimation else total_bytes * 8
    out["bitrate"] = bits * fps / n / 1000.0
    out["encoding_time"] = enc_time / n
    out["decoding_time"] = dec_time / n
    return out


def aggregate_results(seq_results: List[Dict[str, float]]
                      ) -> Dict[str, float]:
    """Mean per metric over sequences (reference __main__.py:88-100)."""
    agg: Dict[str, List[float]] = defaultdict(list)
    for r in seq_results:
        for k, v in r.items():
            agg[k].append(v)
    return {k: float(np.mean(v)) for k, v in agg.items()}


def parse_args(argv):
    p = argparse.ArgumentParser("lmic-torch-video-eval",
                                description="ssf2020 video evaluation")
    p.add_argument("-d", "--dataset", required=True,
                   help="directory of .yuv files (or one file)")
    p.add_argument("-a", "--arch", default="ssf2020")
    p.add_argument("-q", "--quality", type=int, default=1)
    p.add_argument("-m", "--metric", choices=["mse", "ms-ssim"],
                   default="mse")
    p.add_argument("--gop", type=int, default=12)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--checkpoint", default=None,
                   help="training checkpoint (its params; the coding "
                        "tables are built from them)")
    p.add_argument("--entropy-estimation", action="store_true",
                   help="estimate the rate from likelihoods (no coder)")
    p.add_argument("-o", "--output", default=None,
                   help="output directory: per-sequence JSONs plus the "
                        "cumulative {arch}-{metric}-{description}.json "
                        "(reference schema)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; raises without a GPU "
                        "unless 'cpu' is given)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from lmic_tpu_torch import zoo

    codec = zoo.create_video_model(args.arch, quality=args.quality,
                                   device=args.device)
    if args.checkpoint:
        from lmic_tpu_torch.utils.checkpoint import load_train_params

        load_train_params(args.checkpoint, codec.module)
    codec.update(force=True)

    description = "entropy-estimation" if args.entropy_estimation else "ans"
    trained_net = f"{args.arch}-{args.metric}-{args.quality}-{description}"

    path = Path(args.dataset)
    files = [path] if path.is_file() else sorted(path.glob("*.yuv"))
    outdir = Path(args.output) if args.output else None
    if outdir:
        outdir.mkdir(parents=True, exist_ok=True)
    seq_results = []
    for f in files:
        seq = RawVideoSequence.from_file(str(f))
        if seq.video_format != VideoFormat.YUV420:
            print(f"skipping {f.name}: unsupported format")
            continue
        try:
            m = eval_sequence(codec, seq, args.gop, args.max_frames,
                              entropy_estimation=args.entropy_estimation)
        finally:
            seq.close()  # drop the mmap before the next sequence
        seq_results.append(m)
        print(f"{f.name}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
              flush=True)
        if outdir:
            doc = {"source": f.stem, "name": args.arch,
                   "description": f"Inference ({description})", "results": m}
            with open(outdir / f"{f.stem}-{trained_net}.json", "w") as fd:
                json.dump(doc, fd, indent=2)

    if not seq_results or not outdir:
        return
    # the metric is in the cumulative file's name: an mse and an ms-ssim
    # run must not merge into one document (one plotted series a file)
    cum_path = outdir / f"{args.arch}-{args.metric}-{description}.json"
    if cum_path.exists():
        with open(cum_path) as fd:
            output = json.load(fd)
    else:
        output = {"name": f"{args.arch}-{args.metric}",
                  "description": f"Inference ({description})",
                  "results": {}}
    results = defaultdict(list, output["results"])
    results["q"].append(trained_net)
    for k, v in aggregate_results(seq_results).items():
        results[k].append(v)
    output["results"] = dict(results)
    with open(cum_path, "w") as fd:
        json.dump(output, fd, indent=2)
    print(json.dumps(output, indent=2))


if __name__ == "__main__":
    main()
