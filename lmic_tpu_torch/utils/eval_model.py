"""RD evaluation CLI, the compressai.utils.eval_model equivalent
(__main__t.py single-modality and __main__rgbt.py paired modes).

Counterpart of lmic_tpu/utils/eval_model.py. Two modes, as in the
reference:
- entropy estimation: the forward pass alone, bpp from the likelihoods
  (the sum of -log2 of each);
- real coder: compress and decompress through rANS, bpp from the bytes of
  the strings, with wall-clock encoding and decoding times.

Images are padded to a multiple of 64 (2^6) for the hyperprior family and
unpadded before the metrics (reference __main__t.py:101-140). For the
RGB-T pair the bpp adds the beta/gamma side information, 64*2*4*8 bits
(__main__rgbt.py:142). Results append to a JSON list under --output.

Usage:
  lmic-torch-eval --arch mbt2018-mean -q 1 --checkpoint model.ckpt \
      -d /path/images --output results.json [--device cpu]

The device work runs on --device (CUDA by default); PIL is needed only to
read the image files.

`--half` is lmic_tpu's bf16 matmul precision for the coding graph
(lmic_tpu/utils/eval_model.py:331-340): after the tables are built (or
loaded) in f32, every eval call runs under `ops/precision.py`'s mode, so
the transforms' and the entropy parameters' convs and products take
bf16-rounded operands (the GDN and the bottleneck stay f32). A stream
written under `--half` decodes only under `--half`, as in lmic_tpu. The
metrics sum in f64 in every mode (utils/metrics.py), so MS-SSIM's filter
is not rounded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from lmic_tpu_torch import zoo
from lmic_tpu_torch.ops.precision import matmul_precision
from lmic_tpu_torch.utils.determinism import set_wire_determinism
from lmic_tpu_torch.utils.metrics import ms_ssim, psnr

# beta and gamma: 64 f32 each, sent beside the master's strings
RGBT_SIDE_BITS = 64 * 2 * 4 * 8

def pad_to_multiple(x: np.ndarray, p: int = 64):
    """Centre-pad (B, H, W, C) with zeros to multiples of p (the
    reference's F.pad, constant 0)."""
    H, W = x.shape[1:3]
    new_h = (H + p - 1) // p * p
    new_w = (W + p - 1) // p * p
    pl_h = (new_h - H) // 2
    pl_w = (new_w - W) // 2
    pad = ((0, 0), (pl_h, new_h - H - pl_h), (pl_w, new_w - W - pl_w), (0, 0))
    return np.pad(x, pad), (H, W, pl_h, pl_w)


def unpad(x, meta):
    H, W, pl_h, pl_w = meta
    return x[:, pl_h:pl_h + H, pl_w:pl_w + W]


def load_image(path, channel=3) -> np.ndarray:
    """(1, H, W, C) float32 in [0, 1] from an image file."""
    from PIL import Image

    img = Image.open(path).convert("RGB" if channel == 3 else "L")
    arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr[None]


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _bits(likelihoods) -> float:
    return sum(float(-torch.sum(torch.log2(lik)))
               for lik in likelihoods.values())


def _quality(x_hat, x, device) -> Dict[str, float]:
    """psnr and ms-ssim of (1, H, W, C) arrays or tensors, on `device`."""
    x_hat = torch.as_tensor(x_hat).to(device)
    x = torch.as_tensor(x).to(device)
    return {"psnr": float(psnr(x_hat, x)), "ms-ssim": float(ms_ssim(x_hat, x))}


@torch.inference_mode()
def eval_image_forward(codec, x: np.ndarray) -> Dict[str, float]:
    """Entropy-estimation mode: x (1, H, W, C) float in [0, 1]."""
    set_wire_determinism()
    xp, meta = pad_to_multiple(x)
    out = codec.module(codec._pixels(xp), training=False)
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    bpp = _bits(out["likelihoods"]) / num_pixels
    x_hat = unpad(_nhwc(torch.clamp(out["x_hat"], 0, 1)), meta)
    return {**_quality(x_hat, x, codec.device), "bpp": bpp}


def _string_bits(strings) -> float:
    return sum(len(s) for grp in strings for s in grp) * 8.0


def eval_image_codec(codec, x: np.ndarray) -> Dict[str, float]:
    """Real rANS codec mode with timing."""
    xp, meta = pad_to_multiple(x)
    t0 = time.perf_counter()
    out = codec.compress(xp)
    enc_time = time.perf_counter() - t0
    t0 = time.perf_counter()
    rec = codec.decompress(out["strings"], out["shape"])
    dec_time = time.perf_counter() - t0
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    return {
        **_quality(unpad(rec["x_hat"], meta), x, codec.device),
        "bpp": _string_bits(out["strings"]) / num_pixels,
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


@torch.inference_mode()
def eval_rgbt_pair(guided_codec, master_codec, x, guided,
                   entropy_estimation: bool = False) -> Dict[str, float]:
    """Paired eval (reference __main__rgbt.py): code the guide, decode it,
    condition the master on its reconstruction. bpp counts the master's
    strings and the beta/gamma side information."""
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    device = master_codec.device
    if entropy_estimation:
        set_wire_determinism()
        g_fwd = guided_codec.module(guided_codec._pixels(guided),
                                    training=False)
        hidden = {k: v for k, v in g_fwd["hidden"].items()
                  if k.startswith("gs")}
        m_fwd = master_codec.module(master_codec._pixels(x), g_fwd["x_hat"],
                                    hidden, training=False)
        bits = _bits(m_fwd["likelihoods"]) + RGBT_SIDE_BITS
        x_hat = _nhwc(torch.clamp(m_fwd["x_hat"], 0.0, 1.0))
        return {**_quality(x_hat, x, device), "bpp": bits / num_pixels}
    t0 = time.perf_counter()
    # the encoder takes the guide's reconstruction from its own encode
    # loop (equal bit for bit to a decompress of its streams) instead of
    # decoding its own streams as the reference flow does
    g_out = guided_codec.compress(guided, hidden=False, reconstruct=True)
    m_out = master_codec.compress(x, g_out["x_hat"])
    enc_time = time.perf_counter() - t0
    g_dec = {"x_hat": g_out["x_hat"], "hidden": g_out["hidden_dec"]}
    t0 = time.perf_counter()
    m_dec = master_codec.decompress(m_out, g_dec)
    dec_time = time.perf_counter() - t0
    bits = _string_bits(m_out["strings"]) + RGBT_SIDE_BITS
    return {
        **_quality(m_dec["x_hat"], x, device),
        "bpp": bits / num_pixels,
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


@torch.inference_mode()
def eval_rd_pair(guided_codec, master_codec, x, guided,
                 entropy_estimation: bool = False) -> Dict[str, float]:
    """Paired eval of the `_R`/`_D` archs (same-size modalities): the
    guided/master metric set without the beta/gamma side information,
    which the `_D` archs do not send (they fuse hidden maps instead,
    google.py:1006-1423)."""
    num_pixels = x.shape[0] * x.shape[1] * x.shape[2]
    device = master_codec.device
    if entropy_estimation:
        set_wire_determinism()
        g_fwd = guided_codec.module(guided_codec._pixels(guided),
                                    training=False)
        m_fwd = master_codec.module(master_codec._pixels(x),
                                    g_fwd["hidden"], training=False)
        x_hat = _nhwc(torch.clamp(m_fwd["x_hat"], 0.0, 1.0))
        return {**_quality(x_hat, x, device),
                "bpp": _bits(m_fwd["likelihoods"]) / num_pixels}
    t0 = time.perf_counter()
    g_out = guided_codec.compress(guided)
    g_dec = guided_codec.decompress(g_out["strings"], g_out["shape"])
    m_out = master_codec.compress(x, g_out["hidden"])
    enc_time = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_dec = master_codec.decompress(m_out["strings"], m_out["shape"],
                                    g_dec["hidden"])
    dec_time = time.perf_counter() - t0
    return {
        **_quality(m_dec["x_hat"], x, device),
        "bpp": _string_bits(m_out["strings"]) / num_pixels,
        "encoding_time": enc_time,
        "decoding_time": dec_time,
    }


def parse_args(argv):
    p = argparse.ArgumentParser("lmic-torch-eval",
                                description="lmic_tpu_torch RD evaluation")
    p.add_argument("--arch", default="bmshj2018-factorized")
    p.add_argument("-q", "--quality", type=int, default=1)
    p.add_argument("-d", "--dataset", required=True)
    p.add_argument("--channel", type=int, default=3)
    p.add_argument("--checkpoint", default=None,
                   help="deployment checkpoint (utils/update_model_cli.py "
                        "output)")
    p.add_argument("--entropy-estimation", action="store_true")
    p.add_argument("--output", default=None, help="JSON results path")
    p.add_argument("--half", action="store_true",
                   help="bf16 matmul precision for the coding graph (the "
                        "transforms and the entropy parameters); streams "
                        "written under --half decode only under --half")
    # RGB-T paired mode (reference __main__rgbt.py): --arch master (or a
    # `_D` arch) with checkpoints for both codecs; the dataset directory
    # holds the master modality, the guide's is found by swapping RGB and
    # thermal_8_bit in the path
    p.add_argument("--rgbt", action="store_true",
                   help="paired guided+master eval over ImageFolderTest")
    p.add_argument("--guided-checkpoint", default=None)
    p.add_argument("--crop-size", type=int, nargs=2, default=(512, 640),
                   help="master-modality crop; both sides must be "
                        "divisible by 64 (the reference hard-wires 512 640)")
    p.add_argument("--test-ids", default=None,
                   help="comma-separated id substrings, or 'all' "
                        "(default: the reference's 20 fixed FLIR ids)")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; raises without a GPU "
                        "unless 'cpu' is given)")
    return p.parse_args(argv)


def _load_or_update(codec, checkpoint):
    if checkpoint:
        from lmic_tpu_torch.utils.checkpoint import load_updated_model

        return load_updated_model(checkpoint, codec)
    codec.update(force=True)
    return codec


def _precision(args):
    """The mode of the eval calls: bf16 under `--half`, entered after the
    codecs' tables are built or loaded, as lmic_tpu enters it."""
    return matmul_precision("bfloat16" if args.half else None)


def run_rgbt(args) -> List[Dict[str, float]]:
    from lmic_tpu_torch.datasets.image import ImageFolderTest, _resize_np

    rd_pair = args.arch.endswith("_D")
    # `cheng2020-attn_D` pairs with `cheng2020-attn_R` etc.
    guide_arch = args.arch[:-2] + "_R" if rd_pair else "guided"
    master_arch = args.arch if rd_pair else "master"
    guided_codec = _load_or_update(
        zoo.create_model(guide_arch, args.quality, channel=4 - args.channel,
                         device=args.device),
        args.guided_checkpoint)
    master_codec = _load_or_update(
        zoo.create_model(master_arch, args.quality, channel=args.channel,
                         device=args.device),
        args.checkpoint)

    if args.test_ids == "all":
        test_ids = [""]  # substring match: everything
    elif args.test_ids:
        test_ids = args.test_ids.split(",")
    else:
        test_ids = None  # the reference's fixed FLIR validation ids
    ds = ImageFolderTest(args.dataset, crop_size=tuple(args.crop_size),
                         channel=args.channel, test_ids=test_ids)
    pair_eval = eval_rd_pair if rd_pair else eval_rgbt_pair
    results = []
    with _precision(args):
        for i in range(len(ds)):
            x, guided = ds[i]
            if rd_pair:
                guided = _resize_np(guided, x.shape[:2])  # same-size pair
            m = pair_eval(guided_codec, master_codec, x[None], guided[None],
                          entropy_estimation=args.entropy_estimation)
            if i == 0 and not args.entropy_estimation:
                # the first call paid the first launches and allocations:
                # redo it so the recorded times measure coding
                m = pair_eval(guided_codec, master_codec, x[None],
                              guided[None])
            results.append(m)
            print(f"[{i}] " + " ".join(f"{k}={v:.4f}"
                                       for k, v in m.items()), flush=True)
    return results


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.rgbt:
        results = run_rgbt(args)
    else:
        codec = zoo.create_model(args.arch, args.quality,
                                 channel=args.channel, device=args.device)
        if args.checkpoint or not args.entropy_estimation:
            codec = _load_or_update(codec, args.checkpoint)
        files = sorted(
            f for f in Path(args.dataset).iterdir()
            if f.suffix.lower() in {".png", ".jpg", ".jpeg"}
        )
        results = []
        with _precision(args):
            for i, f in enumerate(files):
                x = load_image(f, args.channel)
                if args.entropy_estimation:
                    m = eval_image_forward(codec, x)
                else:
                    m = eval_image_codec(codec, x)
                    if i == 0:
                        # the first call paid the first launches and
                        # allocations: redo it so the times measure coding
                        m = eval_image_codec(codec, x)
                results.append(m)
                print(f"{f.name}: " + " ".join(f"{k}={v:.4f}"
                                               for k, v in m.items()),
                      flush=True)

    agg = {k: float(np.mean([r[k] for r in results]))
           for k in results[0]} if results else {}
    summary = {
        "name": args.arch,
        "description": f"q={args.quality} "
        + ("entropy-estimation" if args.entropy_estimation else "rans"),
        "results": agg,
    }
    print(json.dumps(summary, indent=2))
    if args.output:
        existing = []
        if os.path.exists(args.output):
            with open(args.output) as fh:
                existing = json.load(fh)
        existing.append(summary)
        with open(args.output, "w") as fh:
            json.dump(existing, fh, indent=2)


if __name__ == "__main__":
    main()
