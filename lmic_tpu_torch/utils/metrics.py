"""Image quality metrics on the device: PSNR, SSIM, MS-SSIM.

Counterpart of lmic_tpu/utils/metrics.py: MS-SSIM after Wang et al. 2003
with the standard 5-scale weights and an 11x11 sigma-1.5 Gaussian window,
the definition of pytorch_msssim.ms_ssim that the reference eval CLIs use
(compressai/utils/eval_model/__main__rgbt.py). Inputs are (N, H, W, C)
tensors, as lmic_tpu's arrays are; the sums run on their device.

The window's taps come from `ops/video.py::gaussian_kernel1d`, which are
exact where lmic_tpu's (`jnp.linspace`) are up to 3e-8 off. The sums
run in float64: SSIM's variances are differences of near-equal blurred
moments, and in f32 the cancellation puts MS-SSIM up to 5.5e-6 from the
f64 definition (lmic_tpu's XLA sums land up to 3.0e-6 from it); in f64
the port meets the definition to 1e-14 at the cost of f64 convolutions
(a few milliseconds at 1080p on the card).
"""

from __future__ import annotations

import math
import warnings

import torch
import torch.nn.functional as F

from lmic_tpu_torch.ops.video import gaussian_kernel1d

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _f64(t) -> torch.Tensor:
    return torch.as_tensor(t).double()


def psnr(a, b, max_val: float = 1.0):
    """PSNR of two tensors in [0, max_val], as a 0-d float64 tensor."""
    mse = torch.mean((_f64(a) - _f64(b)) ** 2)
    return 20 * math.log10(max_val) - 10 * torch.log10(mse)


def _blur(x: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable valid-mode Gaussian filter, rows then columns.
    x: (N, C, H, W)."""
    C, k = x.shape[1], kernel1d.shape[0]
    x = F.conv2d(x, kernel1d.view(1, 1, k, 1).expand(C, 1, k, 1), groups=C)
    return F.conv2d(x, kernel1d.view(1, 1, 1, k).expand(C, 1, 1, k),
                    groups=C)


def _ssim_components(x, y, max_val=1.0, win_size=11, sigma=1.5):
    """(N, C, H, W) pair -> the SSIM and contrast-structure maps."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kernel = gaussian_kernel1d(win_size, sigma, x.dtype, x.device)
    mu_x = _blur(x, kernel)
    mu_y = _blur(y, kernel)
    sigma_x = _blur(x * x, kernel) - mu_x ** 2
    sigma_y = _blur(y * y, kernel) - mu_y ** 2
    sigma_xy = _blur(x * y, kernel) - mu_x * mu_y
    cs = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    lum = (2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)
    return lum * cs, cs


def _nchw(t) -> torch.Tensor:
    return _f64(t).permute(0, 3, 1, 2)


def ssim(x, y, max_val: float = 1.0):
    """Mean SSIM over a (N, H, W, C) pair."""
    s, _ = _ssim_components(_nchw(x), _nchw(y), max_val)
    return torch.mean(s)


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool with the canonical odd-size handling:
    pytorch_msssim pads an odd side with one zero row or column (torch
    avg_pool2d padding=s%2, count_include_pad), so the pooled side is
    ceil(s/2); its bottom/right pad is never covered by a stride-2 window,
    so one leading pad reproduces it exactly."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    return F.avg_pool2d(F.pad(x, (pw, 0, ph, 0)), 2)


def ms_ssim(x, y, max_val: float = 1.0):
    """Multi-scale SSIM of a (N, H, W, C) pair with canonical
    pytorch_msssim semantics (what the reference eval CLIs report,
    eval_model/__main__t.py:48): per-channel spatial means, relu per
    level, the 5-level weighted product per (image, channel), then the
    mean; odd sides zero-padded before the downsampling.

    The standard 5 scales whenever the image supports them (min side >
    160, i.e. ceil(side/16) >= 11, pytorch_msssim's own bound); smaller
    images drop the coarsest scales with renormalized weights instead of
    raising, with a warning: a reduced-scale value is another metric."""
    x, y = _nchw(x), _nchw(y)
    n_scales = len(_MSSSIM_WEIGHTS)
    min_side = min(x.shape[2], x.shape[3])
    while n_scales > 1 and -(-min_side // (1 << (n_scales - 1))) < 11:
        n_scales -= 1
    weights = torch.tensor(_MSSSIM_WEIGHTS[:n_scales], dtype=x.dtype,
                           device=x.device)
    if n_scales < len(_MSSSIM_WEIGHTS):
        warnings.warn(
            f"ms_ssim: image min side {min_side} <= 160; using "
            f"{n_scales}-scale MS-SSIM with renormalized weights — not "
            "comparable to standard 5-scale values",
            stacklevel=2,
        )
        weights = weights / torch.sum(weights)
    values = []
    for i in range(n_scales):
        s, cs = _ssim_components(x, y, max_val)
        per_channel = torch.mean(s if i == n_scales - 1 else cs,
                                 dim=(2, 3))  # (N, C)
        values.append(torch.clamp(per_channel, min=0.0))
        if i < n_scales - 1:
            x = _downsample2(x)
            y = _downsample2(y)
    values = torch.stack(values)  # (L, N, C)
    return torch.mean(torch.prod(values ** weights[:, None, None], dim=0))
