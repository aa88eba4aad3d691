"""Bisect a traditional codec's quality to match a target bpp/psnr/ms-ssim
(reference: compressai/utils/find_close/__main__.py:67-106).

Counterpart of lmic_tpu/utils/find_close.py, over the port's
`bench_codecs.CODECS` (metrics on --device, CUDA by default).

Usage:
  lmic-torch-find-close jpeg image.png 0.5 --metric bpp [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from lmic_tpu_torch.utils.bench_codecs import CODECS


QUALITY_RANGES = {
    "jpeg": (1, 100),
    "webp": (1, 100),
    "jpeg2000": (1, 200),
    "bpg": (0, 51),
}
# metrics that decrease as quality parameter increases
INVERSE = {"bpg": True}


def find_closest(codec_name: str, img_path: str, target: float,
                 metric: str = "bpp", max_iters: int = 12, device=None):
    codec = CODECS[codec_name](device=device)
    lo, hi = QUALITY_RANGES[codec_name]
    inverse = INVERSE.get(codec_name, False)
    best = None
    for _ in range(max_iters):
        if hi - lo <= 1:
            break
        mid = (lo + hi) // 2
        res = codec.run(img_path, mid)
        value = res[metric]
        best = (mid, res)
        higher_quality = value < target
        if inverse:
            higher_quality = not higher_quality
        if higher_quality:
            lo = mid
        else:
            hi = mid
    return best


def main(argv=None):
    p = argparse.ArgumentParser(description="match a codec to a target")
    p.add_argument("codec", choices=sorted(QUALITY_RANGES))
    p.add_argument("image")
    p.add_argument("target", type=float)
    p.add_argument("--metric", default="bpp",
                   choices=["bpp", "psnr", "ms-ssim"])
    p.add_argument("--device", default=None,
                   help="torch device of the metrics (default: CUDA; "
                        "raises without a GPU unless given)")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    quality, res = find_closest(args.codec, args.image, args.target,
                                args.metric, device=args.device)
    print(f"quality={quality}: "
          + " ".join(f"{k}={v:.4f}" for k, v in res.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
