"""Pretrained-checkpoint registry: arch/metric/quality -> the reference's
published CompressAI file, and its resolution to a local file.

Counterpart of lmic_tpu/zoo/urls.py (`model_urls`, `cache_dir`,
`pretrained_url`, `_verify_checkpoint_hash`, `fetch_pretrained`,
`load_pretrained_model`); the table is its copy, as data (reference
compressai/zoo/image.py:60-187, compressai/zoo/video.py:44-56). The RGB-T
paper pair (guided/master) has no public URL: the reference distributes
those weights through external links (Readme.md:30-36), so their entries
are None.

`fetch_pretrained` looks in the cache directory first
(`$LMIC_PRETRAINED_DIR`, default `~/.cache/lmic_tpu/pretrained`: the one
lmic_tpu reads, so both packages find the same files), then tries a
download, checked against the sha256 fragment of the file name. Without
network access the error names the path to place the file at.
`load_pretrained_model` converts it (zoo/pretrained.py), adopting its baked
coding tables.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

root_url = "https://compressai.s3.amazonaws.com/models/v1"

_IMG = {
    "bmshj2018-factorized": {
        "mse": {
            1: "bmshj2018-factorized-prior-1-446d5c7f.pth.tar",
            2: "bmshj2018-factorized-prior-2-87279a02.pth.tar",
            3: "bmshj2018-factorized-prior-3-5c6f152b.pth.tar",
            4: "bmshj2018-factorized-prior-4-1ed4405a.pth.tar",
            5: "bmshj2018-factorized-prior-5-866ba797.pth.tar",
            6: "bmshj2018-factorized-prior-6-9b02ea3a.pth.tar",
            7: "bmshj2018-factorized-prior-7-6dfd6734.pth.tar",
            8: "bmshj2018-factorized-prior-8-5232faa3.pth.tar",
        },
        "ms-ssim": {
            1: "bmshj2018-factorized-ms-ssim-1-9781d705.pth.tar",
            2: "bmshj2018-factorized-ms-ssim-2-4a584386.pth.tar",
            3: "bmshj2018-factorized-ms-ssim-3-5352f123.pth.tar",
            4: "bmshj2018-factorized-ms-ssim-4-4f91b847.pth.tar",
            5: "bmshj2018-factorized-ms-ssim-5-b3a88897.pth.tar",
            6: "bmshj2018-factorized-ms-ssim-6-ee028763.pth.tar",
            7: "bmshj2018-factorized-ms-ssim-7-8c265a29.pth.tar",
            8: "bmshj2018-factorized-ms-ssim-8-8811bd14.pth.tar",
        },
    },
    "bmshj2018-hyperprior": {
        "mse": {
            1: "bmshj2018-hyperprior-1-7eb97409.pth.tar",
            2: "bmshj2018-hyperprior-2-93677231.pth.tar",
            3: "bmshj2018-hyperprior-3-6d87be32.pth.tar",
            4: "bmshj2018-hyperprior-4-de1b779c.pth.tar",
            5: "bmshj2018-hyperprior-5-f8b614e1.pth.tar",
            6: "bmshj2018-hyperprior-6-1ab9c41e.pth.tar",
            7: "bmshj2018-hyperprior-7-3804dcbd.pth.tar",
            8: "bmshj2018-hyperprior-8-a583f0cf.pth.tar",
        },
        "ms-ssim": {
            1: "bmshj2018-hyperprior-ms-ssim-1-5cf249be.pth.tar",
            2: "bmshj2018-hyperprior-ms-ssim-2-1ff60d1f.pth.tar",
            3: "bmshj2018-hyperprior-ms-ssim-3-92dd7878.pth.tar",
            4: "bmshj2018-hyperprior-ms-ssim-4-4377354e.pth.tar",
            5: "bmshj2018-hyperprior-ms-ssim-5-c34afc8d.pth.tar",
            6: "bmshj2018-hyperprior-ms-ssim-6-3a6d8229.pth.tar",
            7: "bmshj2018-hyperprior-ms-ssim-7-8747d3bc.pth.tar",
            8: "bmshj2018-hyperprior-ms-ssim-8-cc15b5f3.pth.tar",
        },
    },
    "mbt2018-mean": {
        "mse": {
            1: "mbt2018-mean-1-e522738d.pth.tar",
            2: "mbt2018-mean-2-e54a039d.pth.tar",
            3: "mbt2018-mean-3-723404a8.pth.tar",
            4: "mbt2018-mean-4-6dba02a3.pth.tar",
            5: "mbt2018-mean-5-d504e8eb.pth.tar",
            6: "mbt2018-mean-6-a19628ab.pth.tar",
            7: "mbt2018-mean-7-d5d441d1.pth.tar",
            8: "mbt2018-mean-8-8089ae3e.pth.tar",
        },
        "ms-ssim": {
            1: "mbt2018-mean-ms-ssim-1-5bf9c0b6.pth.tar",
            2: "mbt2018-mean-ms-ssim-2-e2a1bf3f.pth.tar",
            3: "mbt2018-mean-ms-ssim-3-640ce819.pth.tar",
            4: "mbt2018-mean-ms-ssim-4-12626c13.pth.tar",
            5: "mbt2018-mean-ms-ssim-5-1be7f059.pth.tar",
            6: "mbt2018-mean-ms-ssim-6-b83bf379.pth.tar",
            7: "mbt2018-mean-ms-ssim-7-ddf9644c.pth.tar",
            8: "mbt2018-mean-ms-ssim-8-0cc7b94f.pth.tar",
        },
    },
    "mbt2018": {
        "mse": {
            1: "mbt2018-1-3f36cd77.pth.tar",
            2: "mbt2018-2-43b70cdd.pth.tar",
            3: "mbt2018-3-22901978.pth.tar",
            4: "mbt2018-4-456e2af9.pth.tar",
            5: "mbt2018-5-b4a046dd.pth.tar",
            6: "mbt2018-6-7052e5ea.pth.tar",
            7: "mbt2018-7-8ba2bf82.pth.tar",
            8: "mbt2018-8-dd0097aa.pth.tar",
        },
        "ms-ssim": {
            1: "mbt2018-ms-ssim-1-2878436b.pth.tar",
            2: "mbt2018-ms-ssim-2-c41cb208.pth.tar",
            3: "mbt2018-ms-ssim-3-d0dd64e8.pth.tar",
            4: "mbt2018-ms-ssim-4-a120e037.pth.tar",
            5: "mbt2018-ms-ssim-5-9b30e3b7.pth.tar",
            6: "mbt2018-ms-ssim-6-f8b3626f.pth.tar",
            7: "mbt2018-ms-ssim-7-16e6ff50.pth.tar",
            8: "mbt2018-ms-ssim-8-0cb49d43.pth.tar",
        },
    },
    "cheng2020-anchor": {
        "mse": {
            1: "cheng2020-anchor-1-dad2ebff.pth.tar",
            2: "cheng2020-anchor-2-a29008eb.pth.tar",
            3: "cheng2020-anchor-3-e49be189.pth.tar",
            4: "cheng2020-anchor-4-98b0b468.pth.tar",
            5: "cheng2020-anchor-5-23852949.pth.tar",
            6: "cheng2020-anchor-6-4c052b1a.pth.tar",
        },
        "ms-ssim": {
            1: "cheng2020_anchor-ms-ssim-1-20f521db.pth.tar",
            2: "cheng2020_anchor-ms-ssim-2-c7ff5812.pth.tar",
            3: "cheng2020_anchor-ms-ssim-3-c23e22d5.pth.tar",
            4: "cheng2020_anchor-ms-ssim-4-0e658304.pth.tar",
            5: "cheng2020_anchor-ms-ssim-5-c0a95e77.pth.tar",
            6: "cheng2020_anchor-ms-ssim-6-f2dc1913.pth.tar",
        },
    },
    "cheng2020-attn": {
        "mse": {
            1: "cheng2020_attn-mse-1-465f2b64.pth.tar",
            2: "cheng2020_attn-mse-2-e0805385.pth.tar",
            3: "cheng2020_attn-mse-3-2d07bbdf.pth.tar",
            4: "cheng2020_attn-mse-4-f7b0ccf2.pth.tar",
            5: "cheng2020_attn-mse-5-26c8920e.pth.tar",
            6: "cheng2020_attn-mse-6-730501f2.pth.tar",
        },
        "ms-ssim": {
            1: "cheng2020_attn-ms-ssim-1-c5381d91.pth.tar",
            2: "cheng2020_attn-ms-ssim-2-5dad201d.pth.tar",
            3: "cheng2020_attn-ms-ssim-3-5c9be841.pth.tar",
            4: "cheng2020_attn-ms-ssim-4-8b2f647e.pth.tar",
            5: "cheng2020_attn-ms-ssim-5-5ca1f34c.pth.tar",
            6: "cheng2020_attn-ms-ssim-6-216423ec.pth.tar",
        },
    },
    "ssf2020": {
        "mse": {
            1: "ssf2020-mse-1-c1ac1a47.pth.tar",
            2: "ssf2020-mse-2-79ed4e19.pth.tar",
            3: "ssf2020-mse-3-9c8b998d.pth.tar",
            4: "ssf2020-mse-4-577c1eda.pth.tar",
            5: "ssf2020-mse-5-1dd7d574.pth.tar",
            6: "ssf2020-mse-6-59dfb6f9.pth.tar",
            7: "ssf2020-mse-7-4d867411.pth.tar",
            8: "ssf2020-mse-8-26439e20.pth.tar",
            9: "ssf2020-mse-9-e89345c4.pth.tar",
        },
    },
}

model_urls: Dict[str, Dict[str, Dict[int, Optional[str]]]] = {
    arch: {
        metric: {q: f"{root_url}/{name}" for q, name in table.items()}
        for metric, table in metrics.items()
    }
    for arch, metrics in _IMG.items()
}
# the paper RGB-T pair: weights exist only behind the fork's external
# links (reference Readme.md:30-36), no stable URL to register
model_urls["guided"] = {"mse": {q: None for q in range(1, 8)}}
model_urls["master"] = {"mse": {q: None for q in range(1, 8)}}




def cache_dir() -> str:
    return os.environ.get(
        "LMIC_PRETRAINED_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "lmic_tpu",
                     "pretrained"),
    )


def pretrained_url(arch: str, quality: int, metric: str = "mse") -> str:
    try:
        url = model_urls[arch][metric][quality]
    except KeyError:
        raise ValueError(
            f"no pretrained entry for arch={arch!r} metric={metric!r} "
            f"quality={quality}"
        ) from None
    if url is None:
        raise ValueError(
            f"{arch} q={quality}: the reference distributes these weights "
            "only through external links (Readme.md:30-36); obtain the "
            ".pth.tar manually and load it with update_model_cli "
            "--from-torch"
        )
    return url


def _verify_checkpoint_hash(path: str, fname: str) -> None:
    """The zoo file names end in the first 8 hex digits of the file's
    sha256 (`...-446d5c7f.pth.tar`, the torch.hub convention): a download
    that does not match is removed and raises, rather than being cached
    and failing later in `torch.load`."""
    import hashlib
    import re

    m = re.search(r"-([0-9a-f]{8})\.pth\.tar$", fname)
    if not m:
        return
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    if not digest.hexdigest().startswith(m.group(1)):
        os.remove(path)
        raise OSError(
            f"{fname}: sha256 {digest.hexdigest()[:8]} does not match the "
            f"filename fragment {m.group(1)} (corrupted download)"
        )


def fetch_pretrained(arch: str, quality: int, metric: str = "mse") -> str:
    """(arch, metric, quality) -> a local checkpoint path: a cache hit,
    else a download. Raises with the path to place the file at when the
    download fails (no network access)."""
    url = pretrained_url(arch, quality, metric)
    fname = url.rsplit("/", 1)[1]
    path = os.path.join(cache_dir(), fname)
    if os.path.exists(path):
        return path
    os.makedirs(cache_dir(), exist_ok=True)
    import urllib.error
    import urllib.request

    try:
        tmp = path + ".part"
        urllib.request.urlretrieve(url, tmp)
        _verify_checkpoint_hash(tmp, fname)
        os.replace(tmp, path)
        return path
    except (urllib.error.URLError, OSError) as e:
        raise RuntimeError(
            f"could not download {url} ({e}). If this environment has no "
            f"network access, place the file at {path} manually; then "
            "load it via zoo.urls.load_pretrained_model or update_model_cli "
            "--from-torch"
        ) from e


def load_pretrained_model(arch: str, quality: int, metric: str = "mse",
                          **kwargs):
    """The reference's `zoo.<arch>(quality, pretrained=True)`: resolve
    the file, load its weights and adopt its baked tables; `kwargs` go to
    `zoo.pretrained.load_reference_checkpoint` (`device=`, `channel=`)."""
    from lmic_tpu_torch.zoo.pretrained import load_reference_checkpoint

    path = fetch_pretrained(arch, quality, metric)
    return load_reference_checkpoint(arch, path, quality=quality, **kwargs)
