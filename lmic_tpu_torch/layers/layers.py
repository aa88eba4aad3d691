"""Layers of the image codecs' main path: Conv, Deconv and GDN/IGDN.

Counterpart of lmic_tpu/layers/layers.py:32-168. Activations are NCHW in
`torch.channels_last` memory format. Padding follows the reference:

- Conv(k, s):   nn.Conv2d(padding=k//2)                       -> ceil(H/s)
- Deconv(k, s): nn.ConvTranspose2d(padding=k//2,
                output_padding=s-1)                           -> H*s
- GDN/IGDN:     y = x / sqrt(beta + x^2 @ gamma^T) (inverse: * sqrt), the
                channel product in the CUDA kernels of ops/gdn.py on the GPU.

`dtype` is the counterpart of flax's `dtype=`: the compute dtype (e.g.
torch.bfloat16 for AMP training). Parameters stay f32; input, weight and
bias are cast to `dtype` for the computation. None computes in the input's
dtype with the f32 parameters, as the codec (wire) path does.

The JAX Deconv is an input-dilated correlation; nn.ConvTranspose2d with the
flipped, transposed kernel (zoo/convert.py) computes the same function, in
another summation order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lmic_tpu_torch.ops import NonNegativeParametrizer
from lmic_tpu_torch.ops.gdn import gdn_core


def _cast(dtype, *tensors):
    return [t if dtype is None else t.to(dtype) for t in tensors]


class Conv(nn.Conv2d):
    """Strided conv with torch-style symmetric padding (p = k//2)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size // 2)
        self.dtype = dtype  # compute dtype; the parameters stay f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*_cast(self.dtype, x, self.weight,
                                         self.bias))


class Deconv(nn.ConvTranspose2d):
    """Transposed conv with output = input * stride."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size // 2,
                         output_padding=stride - 1)
        self.dtype = dtype  # compute dtype; the parameters stay f32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = _cast(self.dtype, x, self.weight, self.bias)
        return F.conv_transpose2d(x, weight, bias, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class GDN(nn.Module):
    """Generalized divisive normalization (reference layers/gdn.py:41-92):
    y_i = x_i / sqrt(beta_i + sum_j gamma_ij x_j^2)  (inverse: * sqrt).

    `beta` and `gamma` are stored in the sqrt-reparametrized space under the
    reference's names; the reparametrization constants are not state.
    """

    def __init__(self, in_channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.inverse = bool(inverse)
        self.dtype = dtype  # compute dtype; the parameters stay f32
        self.beta_reparam = NonNegativeParametrizer(minimum=beta_min)
        self.gamma_reparam = NonNegativeParametrizer()
        self.beta = nn.Parameter(
            self.beta_reparam.init(torch.ones(in_channels))
        )
        self.gamma = nn.Parameter(
            self.gamma_reparam.init(gamma_init * torch.eye(in_channels))
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the reparametrization runs in the parameters' f32 (its gradients
        # and minimum clamps are precision-sensitive); only the
        # normalization itself runs in the compute dtype
        dtype = x.dtype if self.dtype is None else self.dtype
        x = x.to(dtype)
        beta = self.beta_reparam(self.beta).to(dtype)
        gamma = self.gamma_reparam(self.gamma).to(dtype)
        # the kernel reads (N*H*W, C) rows: channels_last makes the NHWC
        # view contiguous; convs may hand back NCHW, so check, never assume
        if not x.is_contiguous(memory_format=torch.channels_last):
            x = x.contiguous(memory_format=torch.channels_last)
        y = gdn_core(x.permute(0, 2, 3, 1), beta, gamma, self.inverse)
        return y.permute(0, 3, 1, 2)
