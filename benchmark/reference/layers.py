"""Layers of the reference models, plain torch, NCHW.

- conv(k, s): `F.conv2d(padding=k // 2)`; deconv(k, s):
  `F.conv_transpose2d(padding=k // 2, output_padding=s - 1)`.
- GDN: y_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2) (inverse:
  * sqrt), beta and gamma stored sqrt-reparametrized
  (compressai/layers/gdn.py, compressai/ops/parametrizers.py).
- `lower_bound`: max(x, bound) whose gradient passes where x >= bound or
  where the incoming gradient is negative (compressai/ops/bound_ops.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        keep = (x >= ctx.bound) | (g < 0)
        return g * keep.to(g.dtype), None


def lower_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    return _LowerBound.apply(x, float(bound))


def nonnegative(p: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """The effective value of a sqrt-reparametrized parameter."""
    bound = (minimum + PEDESTAL) ** 0.5
    return lower_bound(p, bound) ** 2 - PEDESTAL


def nonnegative_init(v: torch.Tensor) -> torch.Tensor:
    """The stored parameter of an effective value v >= 0."""
    return torch.sqrt(torch.clamp(v + PEDESTAL, min=PEDESTAL))


class Conv(nn.Conv2d):
    def __init__(self, cin, cout, k=5, s=2):
        super().__init__(cin, cout, k, stride=s, padding=k // 2)


class Deconv(nn.ConvTranspose2d):
    def __init__(self, cin, cout, k=5, s=2):
        super().__init__(cin, cout, k, stride=s, padding=k // 2,
                         output_padding=s - 1)


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(torch.ones(channels))
        self.gamma = nn.Parameter(torch.eye(channels))

    def forward(self, x):
        C = x.shape[1]
        beta = nonnegative(self.beta, 1e-6)
        gamma = nonnegative(self.gamma)
        norm = F.conv2d(x * x, gamma.view(C, C, 1, 1), beta)
        norm = torch.sqrt(norm)
        return x * norm if self.inverse else x / norm


def leaky(x):
    return F.leaky_relu(x, 0.01)


class LeakyReLU(nn.Module):
    def forward(self, x):
        return leaky(x)


class SubpelConv(nn.Sequential):
    """3x3 conv to C * r^2 channels, then a pixel shuffle (CompressAI's
    `subpel_conv3x3`: its keys are `<prefix>.0.*`)."""

    def __init__(self, cin, cout, r):
        super().__init__(Conv(cin, cout * r * r, 3, 1), nn.PixelShuffle(r))


class MaskedConv(nn.Conv2d):
    """PixelCNN type-A 5x5 causal conv: rows below the centre and the
    centre row from the centre on are masked out."""

    def __init__(self, cin, cout, k=5):
        super().__init__(cin, cout, k, padding=k // 2)
        mask = torch.ones(k, k)
        mask[k // 2, k // 2:] = 0
        mask[k // 2 + 1:] = 0
        self.register_buffer("mask", mask, persistent=False)
        self.live_taps = (k // 2) * k + k // 2

    def forward(self, x):
        return F.conv2d(x, self.weight * self.mask, self.bias,
                        padding=self.padding)


class ResidualBlockWithStride(nn.Module):
    def __init__(self, cin, cout, stride=2):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, stride)
        self.conv2 = Conv(cout, cout, 3, 1)
        self.gdn = GDN(cout)
        self.skip = Conv(cin, cout, 1, stride)

    def forward(self, x):
        out = self.gdn(self.conv2(leaky(self.conv1(x))))
        return out + self.skip(x)


class ResidualBlockUpsample(nn.Module):
    def __init__(self, cin, cout, r=2):
        super().__init__()
        self.subpel_conv = SubpelConv(cin, cout, r)
        self.conv = Conv(cout, cout, 3, 1)
        self.igdn = GDN(cout, inverse=True)
        self.upsample = SubpelConv(cin, cout, r)

    def forward(self, x):
        out = self.igdn(self.conv(leaky(self.subpel_conv(x))))
        return out + self.upsample(x)


class ResidualBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv1 = Conv(cin, cout, 3, 1)
        self.conv2 = Conv(cout, cout, 3, 1)

    def forward(self, x):
        return leaky(self.conv2(leaky(self.conv1(x)))) + x
