"""Scale-space video ops: the Gaussian pyramid volume and the trilinear
volume warp of ssf2020.

Counterpart of lmic_tpu/ops/video.py (reference
compressai/models/video/google.py:331-375, compressai/models/utils.py:
155-195), on NCHW tensors; the volume is (N, C, D, H, W), as 5-D
`F.grid_sample` takes it.

`warp_volume` keeps lmic_tpu's arithmetic (its 8-corner gather and the
lerps in the same order), not `F.grid_sample`'s, so that the CPU strings
can match lmic_tpu's; `F.grid_sample(..., mode="bilinear",
padding_mode="border", align_corners=False)` computes the same function
and is the tests' cross-check. Conventions (align_corners=False):

  normalized coordinate c in [-1, 1] -> pixel p = ((c + 1) * S - 1) / 2
  border padding: p clamped to [0, S - 1].

The Gaussian kernel's taps are `arange(k) - (k - 1) / 2` (exact, where
`jnp.linspace` may be an ulp off), and the 11x11 blur is one depthwise
conv with the 2-D outer-product kernel, not two 1-D passes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_kernel1d(kernel_size: int, sigma: float,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    x = (torch.arange(kernel_size, dtype=dtype, device=device)
         - (kernel_size - 1) / 2.0)
    pdf = torch.exp(-0.5 * (x / sigma) ** 2)
    # elementwise true division (a tensor divided by a scalar may be a
    # product with the reciprocal)
    return pdf / pdf.sum().expand_as(pdf)


def gaussian_kernel2d(kernel_size: int, sigma: float,
                      dtype=torch.float32, device=None) -> torch.Tensor:
    k = gaussian_kernel1d(kernel_size, sigma, dtype, device)
    return torch.outer(k, k)


def gaussian_blur(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 2-D blur with replicate padding. x: (N, C, H, W)."""
    pad = kernel.shape[0] // 2
    C = x.shape[1]
    x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    weight = kernel.to(x.dtype).expand(C, 1, *kernel.shape)
    return F.conv2d(x, weight, groups=C)


def avg_pool2x2(x: torch.Tensor) -> torch.Tensor:
    return F.avg_pool2d(x, kernel_size=2, stride=2)


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 upsampling, half-pixel centres (align_corners=False),
    the edge pixel repeated."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def gaussian_volume(x: torch.Tensor, sigma: float,
                    num_levels: int) -> torch.Tensor:
    """Scale-space volume (reference video/google.py:331-355).

    x: (N, C, H, W) -> (N, C, D, H, W) with D = num_levels + 1: level 0 is
    x, level 1 blur(x), level i > 1 the upsampled blur of the
    2^(i-1)-downsampled image."""
    k = 2 * int(math.ceil(3 * sigma)) + 1
    kernel = gaussian_kernel2d(k, sigma, x.dtype, x.device)
    volume = [x]
    x = gaussian_blur(x, kernel)
    volume.append(x)
    for i in range(1, num_levels):
        x = gaussian_blur(avg_pool2x2(x), kernel)
        interp = x
        for _ in range(i):
            interp = upsample2x_bilinear(interp)
        volume.append(interp)
    return torch.stack(volume, dim=2)


def base_grid(H: int, W: int, dtype=torch.float32, device=None):
    """Identity sampling grid, normalized to [-1, 1] at pixel centres
    (`F.affine_grid(..., align_corners=False)`): (gx, gy), each (H, W)."""
    xs = (2.0 * torch.arange(W, dtype=dtype, device=device) + 1.0) / W - 1.0
    ys = (2.0 * torch.arange(H, dtype=dtype, device=device) + 1.0) / H - 1.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return gx, gy


def warp_volume(volume: torch.Tensor, flow: torch.Tensor,
                scale_field: torch.Tensor) -> torch.Tensor:
    """Trilinear scale-space warp.

    volume: (N, C, D, H, W); flow: (N, 2, H, W), (dx, dy) in normalized
    units; scale_field: (N, 1, H, W), the depth coordinate in [-1, 1].
    Returns (N, C, H, W): 5-D `F.grid_sample` with padding_mode="border"
    and align_corners=False (reference video/google.py:357-375)."""
    N, C, D, H, W = volume.shape
    gx, gy = base_grid(H, W, volume.dtype, volume.device)
    cx = gx + flow[:, 0]
    cy = gy + flow[:, 1]
    cz = scale_field[:, 0]

    # normalized -> pixel coordinates, border clamp
    px = torch.clamp(((cx + 1.0) * W - 1.0) / 2.0, 0.0, W - 1.0)
    py = torch.clamp(((cy + 1.0) * H - 1.0) / 2.0, 0.0, H - 1.0)
    pz = torch.clamp(((cz + 1.0) * D - 1.0) / 2.0, 0.0, D - 1.0)

    x0, y0, z0 = torch.floor(px), torch.floor(py), torch.floor(pz)
    wx, wy, wz = ((px - x0)[:, None], (py - y0)[:, None],
                  (pz - z0)[:, None])
    x0, y0, z0 = x0.long(), y0.long(), z0.long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    z1 = torch.clamp(z0 + 1, max=D - 1)

    flat = volume.reshape(N, C, D * H * W)

    def gather(zi, yi, xi):
        index = ((zi * H + yi) * W + xi).reshape(N, 1, H * W)
        return torch.gather(flat, 2, index.expand(N, C, H * W)).view(
            N, C, H, W)

    c000 = gather(z0, y0, x0)
    c001 = gather(z0, y0, x1)
    c010 = gather(z0, y1, x0)
    c011 = gather(z0, y1, x1)
    c100 = gather(z1, y0, x0)
    c101 = gather(z1, y0, x1)
    c110 = gather(z1, y1, x0)
    c111 = gather(z1, y1, x1)

    c00 = c000 * (1 - wx) + c001 * wx
    c01 = c010 * (1 - wx) + c011 * wx
    c10 = c100 * (1 - wx) + c101 * wx
    c11 = c110 * (1 - wx) + c111 * wx
    c0 = c00 * (1 - wy) + c01 * wy
    c1 = c10 * (1 - wy) + c11 * wy
    return c0 * (1 - wz) + c1 * wz


def scale_space_warp(x_ref: torch.Tensor, flow: torch.Tensor,
                     scale_field: torch.Tensor, sigma0: float,
                     num_levels: int) -> torch.Tensor:
    """forward_prediction (reference video/google.py:377-382)."""
    volume = gaussian_volume(x_ref, sigma0, num_levels)
    return warp_volume(volume, flow, scale_field)
