"""The reference of the mean-scale hyperprior codec's round trip, and the
numbers that decide a codec cell's `correct`.

The program's outputs are judged: its strings are decoded here (NumPy
rANS, tables worked out again from the weights) and its uint8 pixels are
compared with this synthesis of the decoded symbols.

The wire, as CompressAI has it: z symbols = round(z - medians),
channel-major, one bottleneck CDF row a channel; the scale index of a y
symbol = 63 - #{s in table[:-1] : max(sigma, 0.11) <= s}, from h_s of the
decoded z; y symbols = round(y - means), channel-major. The reference's
h_s sums in its own order, so a scale that lies within `DOUBT` (relative)
of a bucket edge may fall in the other bucket on the coder's side; there
the decoder weighs both rows (`rans.decode`) against the symbols the
reference's own analysis expects.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import entropy, rans

DOUBT = 1e-4


class Tables:
    """The bottleneck's and the Gaussian conditional's decode tables."""

    def __init__(self, model):
        cdf, length, offset, medians = model.entropy_bottleneck.table()
        self.z = rans.Table(cdf, length, offset)
        self.medians = medians
        self.scales = entropy.scale_table()
        self.y = rans.Table(*entropy.gaussian_tables(self.scales))


def scale_index(scales: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    scales = torch.clamp_min(scales, entropy.SCALE_BOUND)
    counts = (scales[..., None] <= table[:-1]).sum(-1)
    return (len(table) - 1) - counts


def u8(x: torch.Tensor) -> torch.Tensor:
    """A synthesis (B, 3, H, W) -> uint8 (B, H, W, 3)."""
    x = torch.round(torch.clamp(x, 0, 1) * 255).to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous()


class Image:
    """The reference's view of one image: its analysis, and what the wire
    z symbols of the candidate imply."""

    def __init__(self, model, tables: Tables, pixels: torch.Tensor):
        dev = pixels.device
        self.model, self.tables = model, tables
        self.med = torch.as_tensor(tables.medians, device=dev).view(1, -1, 1,
                                                                    1)
        self.y, z = model.analysis(pixels.float() / 255)
        self.z_sym = torch.round(z - self.med)

    def params(self, z_sym: torch.Tensor):
        """(scales, means) of wire z symbols."""
        return self.model.hyper_synthesis(z_sym.float() + self.med)


@torch.no_grad()
def decode_and_judge(model, tables: Tables, pixels: torch.Tensor, strings,
                     shape, x_hat: torch.Tensor) -> Dict[str, List[float]]:
    """The program's strings ([y strings, z strings], z's (h, w)) and
    uint8 pixels of a batch (B, H, W, 3), judged image by image."""
    dev = pixels.device
    B = pixels.shape[0]
    y_strings, z_strings = strings
    N = len(tables.medians)
    h, w = shape
    z_rows = np.repeat(np.arange(N), h * w)[None].repeat(B, 0)
    z = torch.as_tensor(rans.decode(z_strings, z_rows, tables.z),
                        device=dev).view(B, N, h, w)
    table = torch.as_tensor(tables.scales, device=dev)
    imgs, rows, alt, expected = [], [], [], []
    for i in range(B):
        im = Image(model, tables, pixels[i:i + 1])
        scales, means = im.params(z[i:i + 1])
        imgs.append((im, means))
        idx = scale_index(scales, table)
        lo = scale_index(scales * (1 - DOUBT), table)
        hi = scale_index(scales * (1 + DOUBT), table)
        rows.append(idx.reshape(-1))
        alt.append(torch.where(lo != idx, lo, hi).reshape(-1))
        expected.append(torch.round(im.y - means).reshape(-1))
    y = rans.decode(y_strings, torch.stack(rows).cpu().numpy(), tables.y,
                    torch.stack(alt).cpu().numpy(),
                    torch.stack(expected).cpu().numpy())
    y = torch.as_tensor(y, device=dev).view(B, *imgs[0][0].y.shape[1:])
    return _judge(imgs, z, y, x_hat)


def _judge(imgs, z_cand, y_cand, x_cand):
    """Per image, parts per million of the candidate's symbols (z and y)
    that differ from the reference's own analysis, and of its uint8 pixel
    values that differ from the reference synthesis of the candidate's
    symbols (with the means of the candidate's z symbols, as a decoder
    has them)."""
    sym, pix = [], []
    for i, (im, means) in enumerate(imgs):
        dev = im.y.device
        zc, yc = z_cand[i:i + 1].to(dev), y_cand[i:i + 1].to(dev).float()
        y_ref = torch.round(im.y - means)
        bad = (zc != im.z_sym).sum() + (yc != y_ref).sum()
        sym.append(1e6 * float(bad) / (zc.numel() + yc.numel()))
        x_ref = u8(im.model.g_s(yc + means))
        pix.append(1e6 * float((x_ref != x_cand[i:i + 1].to(dev)).sum())
                   / x_ref.numel())
    return {"sym_ppm": sym, "pix_ppm": pix}


@torch.no_grad()
def judge(model, tables: Tables, pixels, z_cand, y_cand, x_cand):
    """A candidate's symbols and pixels (the control's), judged as the
    program's are."""
    imgs = []
    for i in range(pixels.shape[0]):
        im = Image(model, tables, pixels[i:i + 1])
        imgs.append((im, im.params(z_cand[i:i + 1].to(pixels.device))[1]))
    return _judge(imgs, z_cand, y_cand, x_cand)


@torch.no_grad()
def reference_in_place(model, tables: Tables, pixels: torch.Tensor):
    """The reference itself as the coder (the control runs it with TF32
    on): (z symbols, y symbols, uint8 pixels) of a uint8 batch."""
    zs, ys, xs = [], [], []
    for i in range(pixels.shape[0]):
        im = Image(model, tables, pixels[i:i + 1])
        _, means = im.params(im.z_sym)
        y_sym = torch.round(im.y - means)
        zs.append(im.z_sym)
        ys.append(y_sym)
        xs.append(u8(model.g_s(y_sym + means)))
    return torch.cat(zs), torch.cat(ys), torch.cat(xs)
