"""Colour-space transforms (BT.709) on channel-last tensors.

Counterpart of lmic_tpu/transforms/functional.py (reference
compressai/transforms/functional.py:26-137): tensors are (..., H, W, C)
torch tensors on any device, as lmic_tpu's arrays are (..., H, W, C).

The chroma upsampling of `yuv_420_to_444` reproduces `jax.image.resize`,
not `F.interpolate`: for "bicubic" JAX uses Keys' cubic with a = -0.5
(torch: -0.75), drops the taps that fall outside the image and
renormalizes the rest to sum 1 (torch clamps them to the edge pixel). So
the port builds JAX's 1-D weight matrices (`resize_weights`) and applies
them as two products; "bilinear" (a triangle kernel) goes the same way,
"nearest" picks `floor((i + 0.5) * in / out)` as JAX does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

YCBCR_WEIGHTS = {
    # Kr, Kg, Kb with Kg = 1 - Kr - Kb
    "ITU-R_BT.709": (0.2126, 0.7152, 0.0722),
}


def rgb2ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> YCbCr, BT.709."""
    Kr, Kg, Kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = Kr * r + Kg * g + Kb * b
    cb = 0.5 * (b - y) / (1 - Kb) + 0.5
    cr = 0.5 * (r - y) / (1 - Kr) + 0.5
    return torch.stack((y, cb, cr), dim=-1)


def ycbcr2rgb(ycbcr: torch.Tensor) -> torch.Tensor:
    """(..., 3) YCbCr -> RGB, BT.709."""
    Kr, Kg, Kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    y, cb, cr = ycbcr[..., 0], ycbcr[..., 1], ycbcr[..., 2]
    r = y + (2 - 2 * Kr) * (cr - 0.5)
    b = y + (2 - 2 * Kb) * (cb - 0.5)
    g = (y - Kr * r - Kb * b) / Kg
    return torch.stack((r, g, b), dim=-1)


def yuv_444_to_420(yuv, mode: str = "avg_pool"):
    """(N, H, W, 3) -> ((N, H, W, 1), (N, H/2, W/2, 1), (N, H/2, W/2, 1)),
    chroma by a 2x2 average pool (an odd last row or column dropped)."""
    if mode not in ("avg_pool",):
        raise ValueError(f'Invalid downsampling mode "{mode}".')
    if isinstance(yuv, (tuple, list)):
        y, u, v = yuv
    else:
        y, u, v = (yuv[..., i:i + 1] for i in range(3))

    def down(t):
        return F.avg_pool2d(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)

    return y, down(u), down(v)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def resize_weights(n_in: int, n_out: int, method: str, device=None
                   ) -> torch.Tensor:
    """The (n_out, n_in) f32 matrix `jax.image.resize` applies along one
    axis when it upsamples (`compute_weight_mat` with no translation):
    kernel(|sample - j|) at half-pixel sample positions, each row
    renormalized to sum 1 over the taps inside the image."""
    if n_out < n_in:
        raise ValueError("resize_weights covers upsampling only")
    inv_scale = n_in / n_out
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    x = torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None])
    w = _KERNELS[method](x)  # (n_in, n_out)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).t()


def _nearest_index(n_in: int, n_out: int, device=None) -> torch.Tensor:
    offsets = (torch.arange(n_out, dtype=torch.float32, device=device)
               + 0.5) * n_in / n_out
    return torch.floor(offsets).long()


def upsample2x(t: torch.Tensor, method: str) -> torch.Tensor:
    """(N, H, W, C) -> (N, 2H, 2W, C) as `jax.image.resize(t, (N, 2H, 2W,
    C), method)` computes it."""
    _, H, W, _ = t.shape
    if method == "nearest":
        t = t[:, _nearest_index(H, 2 * H, t.device)]
        return t[:, :, _nearest_index(W, 2 * W, t.device)]
    wh = resize_weights(H, 2 * H, method, t.device).to(t.dtype)
    ww = resize_weights(W, 2 * W, method, t.device).to(t.dtype)
    return torch.einsum("nhwc,ph,qw->npqc", t, wh, ww)


def yuv_420_to_444(yuv, mode: str = "bilinear", return_tuple: bool = False):
    """((N, H, W, 1), (N, H/2, W/2, 1), (N, H/2, W/2, 1)) -> (N, H, W, 3)."""
    if len(yuv) != 3:
        raise ValueError("Expected a tuple of 3 arrays")
    if mode not in ("bilinear", "bicubic", "nearest"):
        raise ValueError(f'Invalid upsampling mode "{mode}".')
    y, u, v = yuv
    u, v = upsample2x(u, mode), upsample2x(v, mode)
    if return_tuple:
        return y, u, v
    return torch.cat((y, u, v), dim=-1)
