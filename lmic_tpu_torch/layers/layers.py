"""Layers of the image codecs' main path: Conv, Deconv and GDN/IGDN.

Counterpart of lmic_tpu/layers/layers.py:32-168. Activations are NCHW in
`torch.channels_last` memory format. Padding follows the reference:

- Conv(k, s):   nn.Conv2d(padding=k//2)                       -> ceil(H/s)
- Deconv(k, s): nn.ConvTranspose2d(padding=k//2,
                output_padding=s-1)                           -> H*s
- GDN/IGDN:     y = x / sqrt(beta + x^2 @ gamma^T) (inverse: * sqrt), the
                channel product in the CUDA kernel of ops/gdn.py on the GPU.

The JAX Deconv is an input-dilated correlation; nn.ConvTranspose2d with the
flipped, transposed kernel (zoo/convert.py) computes the same function, in
another summation order.
"""

from __future__ import annotations

import torch
from torch import nn

from lmic_tpu_torch.ops import NonNegativeParametrizer
from lmic_tpu_torch.ops.gdn import gdn_core


class Conv(nn.Conv2d):
    """Strided conv with torch-style symmetric padding (p = k//2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size // 2)


class Deconv(nn.ConvTranspose2d):
    """Transposed conv with output = input * stride."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size // 2,
                         output_padding=stride - 1)


class GDN(nn.Module):
    """Generalized divisive normalization (reference layers/gdn.py:41-92):
    y_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2)  (inverse: * sqrt).

    `beta` and `gamma` are stored in the sqrt-reparametrized space under the
    reference's names; the reparametrization constants are not state.
    """

    def __init__(self, in_channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.inverse = bool(inverse)
        self.beta_reparam = NonNegativeParametrizer(minimum=beta_min)
        self.gamma_reparam = NonNegativeParametrizer()
        self.beta = nn.Parameter(
            self.beta_reparam.init(torch.ones(in_channels))
        )
        self.gamma = nn.Parameter(
            self.gamma_reparam.init(gamma_init * torch.eye(in_channels))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = self.beta_reparam(self.beta).to(x.dtype)
        gamma = self.gamma_reparam(self.gamma).to(x.dtype)
        # the kernel reads (N*H*W, C) rows: channels_last makes the NHWC
        # view contiguous; convs may hand back NCHW, so check, never assume
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous(memory_format=torch.channels_last)
        y = gdn_core(x.permute(0, 2, 3, 1), beta, gamma, self.inverse)
        return y.permute(0, 3, 1, 2)
