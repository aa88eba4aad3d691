"""Layers of the image codecs: Conv, Deconv, GDN/IGDN, and the sub-pixel,
masked-context, residual and attention blocks of the AR family.

Counterpart of lmic_tpu/layers/layers.py:32-168, 207-345, 347-371 (qrelu),
374-414 (ESA, SELayer). Activations are
NCHW in `torch.channels_last` memory format. Padding follows the reference:

- Conv(k, s):   nn.Conv2d(padding=k//2)                       -> ceil(H/s)
- Deconv(k, s): nn.ConvTranspose2d(padding=k//2,
                output_padding=s-1)                           -> H*s
- GDN/IGDN:     y = x / sqrt(beta + x^2 @ gamma^T) (inverse: * sqrt), the
                channel product in the CUDA kernels of ops/gdn.py on the GPU.
- MaskedConv2d: PixelCNN mask A/B multiplied into the kernel at call time.
- The residual and attention blocks keep CompressAI's submodule names
  (`conv1`, `conv2`, `gdn`, `skip`, `subpel_conv`, `conv`, `igdn`,
  `upsample`, `conv_a`, `conv_b`; compressai/layers/layers.py:98-244), so
  their `state_dict()` keys are CompressAI's.

`dtype` is the counterpart of flax's `dtype=`: the compute dtype (e.g.
torch.bfloat16 for AMP training). Parameters stay f32; input, weight and
bias are cast to `dtype` for the computation. None computes in the input's
dtype with the f32 parameters, as the codec (wire) path does.

The JAX Deconv is an input-dilated correlation; nn.ConvTranspose2d with the
flipped, transposed kernel (zoo/convert.py) computes the same function, in
another summation order.

Every conv and product here that lmic_tpu leaves at its default precision
goes through `ops/precision.py` (Conv on all its routes, Deconv,
MaskedConv2d, and `Conv2d`/`ConvTranspose2d`/`Linear` for the raw ones):
the plain op, or under `precision.matmul_precision("bfloat16")` (`--bf16`,
`--half`) one on bf16-rounded operands. The GDN keeps f32 (HIGHEST in
lmic_tpu).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from lmic_tpu_torch.layers import remat
from lmic_tpu_torch.ops import NonNegativeParametrizer, precision
from lmic_tpu_torch.ops.gdn import gdn_core


def _cast(dtype, *tensors):
    return [t if dtype is None else t.to(dtype) for t in tensors]


def _conv_gemm(x, weight, bias, padding):
    """A stride-1 convolution as im2col and one cuBLAS product (the
    computation of torch's own non-cuDNN path), NCHW out."""
    B, _, H, W = x.shape
    cols = F.unfold(x, weight.shape[2:], padding=padding)  # (B, C*k*k, H*W)
    out = precision.matmul(weight.flatten(1), cols) + bias[:, None]
    return out.view(B, -1, H, W)


class Conv(nn.Conv2d):
    """Strided conv with torch-style symmetric padding (p = k//2).

    Without autograd on the card, a stride-1 k x k (k > 1) conv runs as
    im2col + GEMM (`_conv_gemm`) instead of cuDNN: with TF32 off, cuDNN's
    heuristics pick an FFT engine of tens of thousands of small launches
    for the 192 -> 192 channel convs at 128x192 (cheng2020 at N = 192 on
    a 512x768 image), some hundred times slower than this route
    (`chip_smoke.py` logs both). The route is deterministic, and its cost
    follows the size of its product. On the CPU and under autograd the
    conv is the CPU's or cuDNN's.

    A 1x1 conv at stride s > 1 (cheng2020's skip paths) reads every s-th
    pixel only: it runs as a stride-1 1x1 conv of that subsampled view,
    the same sums. torch's CPU weight gradient of the strided 1x1 conv
    on a channels_last input of 2 to 4 channels writes past its buffer
    (heap corruption, torch 2.13 CPU; the first skip of cheng2020's g_a
    takes the 3-channel image)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, stride: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=kernel_size // 2)
        self.dtype = dtype  # compute dtype; the parameters stay f32
        self._gemm_route = stride == 1 and kernel_size > 1
        self._subsample = stride if kernel_size == 1 and stride > 1 else 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, weight, bias = _cast(self.dtype, x, self.weight, self.bias)
        if self._gemm_route and x.is_cuda and not torch.is_grad_enabled():
            return _conv_gemm(x, weight, bias, self.padding)
        if self._subsample:
            s = self._subsample
            return precision.conv2d(x[:, :, ::s, ::s], weight, bias)
        return precision.conv2d(x, weight, bias, self.stride, self.padding)


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
        return precision.conv_transpose2d(x, weight, bias, self.stride,
                                          self.padding, self.output_padding)


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` through `precision.conv2d` (the layers that lmic_tpu
    builds as a raw `nn.Conv`: ESA's VALID conv, the Swin patch
    embeds)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.conv2d(x, self.weight, self.bias, self.stride,
                                self.padding, self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """`nn.ConvTranspose2d` through `precision.conv_transpose2d` (the
    Swin aligners' recovery)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.conv_transpose2d(
            x, self.weight, self.bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """`nn.Linear` through `precision.linear` (flax's `nn.Dense`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.linear(x, self.weight, self.bias)


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


class GDNStack(nn.Sequential):
    """An `nn.Sequential` of convs and GDNs (an analysis or synthesis
    transform) whose blocks under `remat.rematerialize()` are its conv +
    GDN pairs, the last conv joining the last pair: the stack keeps one
    activation a resolution instead of two, and the full-resolution
    output of a synthesis is never kept."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = [[]]
        for layer in self:
            parts[-1].append(layer)
            if isinstance(layer, GDN):
                parts.append([])
        if len(parts) > 1:  # the last conv joins the last pair
            tail = parts.pop()
            parts[-1] += tail
        for part in parts:
            x = remat.sequence(part, x)
        return x


class Block(nn.Sequential):
    """An `nn.Sequential` that is one block under `remat.rematerialize()`
    (the hyper transforms)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat.run(super().forward, x)


class _QReLU(torch.autograd.Function):
    """Clamp to [0, 2^bit_depth - 1]; outside the range the gradient is
    the gamma-decay surrogate (reference layers.py:247-296)."""

    @staticmethod
    def forward(ctx, x, bit_depth, beta):
        ctx.save_for_backward(x)
        ctx.bit_depth, ctx.beta = bit_depth, beta
        return torch.clamp(x, 0, 2**bit_depth - 1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        alpha = 0.9943258522851727
        max_value = 2**ctx.bit_depth - 1
        grad_sub = torch.exp(
            (-(alpha**ctx.beta))
            * torch.abs(2.0 * x / max_value - 1) ** ctx.beta
        ) * g
        out_of_range = (x < 0) | (x > max_value)
        return torch.where(out_of_range, grad_sub, g), None, None


def qrelu(x: torch.Tensor, bit_depth: int = 8, beta: int = 100
          ) -> torch.Tensor:
    """QReLU of ssf2020's scale hyper decoder: `clamp(x, 0, 255)` with the
    surrogate gradient of `_QReLU` (lmic_tpu's `qrelu` custom VJP)."""
    return _QReLU.apply(x, bit_depth, beta)


def conv3x3(in_channels: int, out_channels: int, stride: int = 1,
            dtype: Optional[torch.dtype] = None) -> Conv:
    return Conv(in_channels, out_channels, 3, stride, dtype=dtype)


def conv1x1(in_channels: int, out_channels: int, stride: int = 1,
            dtype: Optional[torch.dtype] = None) -> Conv:
    return Conv(in_channels, out_channels, 1, stride, dtype=dtype)


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, C*r^2, H, W) -> (B, C, H*r, W*r), nn.PixelShuffle's channel
    order (c-major, then row offset, then column offset), as lmic_tpu's
    NHWC `pixel_shuffle` documents it."""
    return F.pixel_shuffle(x, r)


class SubpelConv3x3(nn.Sequential):
    """3x3 conv + PixelShuffle upsampling (reference layers.py:86-91: a
    Sequential, so the conv's keys are `{prefix}.0.*`)."""

    def __init__(self, in_channels: int, out_channels: int, r: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(conv3x3(in_channels, out_channels * r * r,
                                 dtype=dtype), nn.PixelShuffle(r))


def make_causal_mask(kh: int, kw: int, mask_type: str = "A") -> torch.Tensor:
    """PixelCNN raster-order kernel mask (reference layers.py:64-73):
    (kh, kw) float, rows below the centre zero, the centre row zero from
    the centre pixel (type A) or right of it (type B)."""
    if mask_type not in ("A", "B"):
        raise ValueError(f'Invalid "mask_type" value "{mask_type}"')
    mask = torch.ones((kh, kw))
    mask[kh // 2, kw // 2 + (mask_type == "B"):] = 0
    mask[kh // 2 + 1:] = 0
    return mask


class MaskedConv2d(nn.Conv2d):
    """Causal (PixelCNN) convolution of the context model. The mask
    multiplies the kernel at call time; the weight is never changed in
    place (unlike the reference's layers.py:75-78). The mask is a buffer
    outside the `state_dict`: it is a function of the shape and type."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, mask_type: str = "A",
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size,
                         padding=kernel_size // 2)
        self.dtype = dtype  # compute dtype; the parameters stay f32
        self.register_buffer(
            "mask", make_causal_mask(kernel_size, kernel_size, mask_type),
            persistent=False,
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return precision.conv2d(*_cast(self.dtype, x,
                                       self.weight * self.mask, self.bias),
                                padding=self.padding)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


class ResidualBlockWithStride(nn.Module):
    """conv3x3(s) -> leaky ReLU -> conv3x3 -> GDN, plus a conv1x1(s) skip
    when the shape changes (reference layers.py:98-129)."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = conv3x3(in_channels, out_channels, stride, dtype=dtype)
        self.conv2 = conv3x3(out_channels, out_channels, dtype=dtype)
        self.gdn = GDN(out_channels, dtype=dtype)
        self.skip = None
        if stride != 1 or in_channels != out_channels:
            self.skip = conv1x1(in_channels, out_channels, stride,
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat.run(self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.gdn(self.conv2(_leaky(self.conv1(x))))
        identity = x if self.skip is None else self.skip(x)
        return out + identity.to(out.dtype)


class ResidualBlockUpsample(nn.Module):
    """Sub-pixel conv up -> leaky ReLU -> conv3x3 -> IGDN, plus a sub-pixel
    skip (reference layers.py:132-157)."""

    def __init__(self, in_channels: int, out_channels: int,
                 upsample: int = 2, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.subpel_conv = SubpelConv3x3(in_channels, out_channels,
                                         upsample, dtype=dtype)
        self.conv = conv3x3(out_channels, out_channels, dtype=dtype)
        self.igdn = GDN(out_channels, inverse=True, dtype=dtype)
        self.upsample = SubpelConv3x3(in_channels, out_channels, upsample,
                                      dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat.run(self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.igdn(self.conv(_leaky(self.subpel_conv(x))))
        return out + self.upsample(x)


class ResidualBlock(nn.Module):
    """Two 3x3 convs with leaky ReLUs, plus a conv1x1 skip when the width
    changes (reference layers.py:160-190)."""

    def __init__(self, in_channels: int, out_channels: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = conv3x3(in_channels, out_channels, dtype=dtype)
        self.conv2 = conv3x3(out_channels, out_channels, dtype=dtype)
        self.skip = None
        if in_channels != out_channels:
            self.skip = conv1x1(in_channels, out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat.run(self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _leaky(self.conv2(_leaky(self.conv1(x))))
        identity = x if self.skip is None else self.skip(x)
        return out + identity.to(out.dtype)


class _ResidualUnit(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck of AttentionBlock, ReLU after the
    sum."""

    def __init__(self, N: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Sequential(
            conv1x1(N, N // 2, dtype=dtype), nn.ReLU(),
            conv3x3(N // 2, N // 2, dtype=dtype), nn.ReLU(),
            conv1x1(N // 2, N, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return F.relu(out + x.to(out.dtype))


class AttentionBlock(nn.Module):
    """Cheng2020's sigmoid-gated trunk/mask attention
    (reference layers.py:193-244): x + conv_a(x) * sigmoid(conv_b(x))."""

    def __init__(self, N: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv_a = nn.Sequential(*(_ResidualUnit(N, dtype)
                                      for _ in range(3)))
        self.conv_b = nn.Sequential(*(_ResidualUnit(N, dtype)
                                      for _ in range(3)),
                                    conv1x1(N, N, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat.run(self._forward, x)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.conv_a(x), self.conv_b(x)
        return x + (a * torch.sigmoid(b)).to(x.dtype)


class ESA(nn.Module):
    """Enhanced spatial attention (reference google.py:1432-1459): a
    strided conv and a max pool make a low-resolution saliency field,
    resized back bilinearly and sigmoid-gated onto the input.

    `conv2` is a raw 3x3 conv at stride 2 without padding (VALID), and
    lmic_tpu's 7x7, stride-3 VALID `reduce_window` max is `max_pool2d`;
    `jax.image.resize(..., "bilinear")` of an upsampling is
    `F.interpolate(align_corners=False)` (half-pixel centres, the edge
    pixel repeated). The input needs 15 or more pixels a side."""

    def __init__(self, N: int):
        super().__init__()
        f = N // 4
        self.conv1 = Conv(N, f, 1, 1)
        self.conv2 = Conv2d(f, f, 3, stride=2, padding=0)
        self.conv_max = conv3x3(f, f)
        self.conv3 = conv3x3(f, f)
        self.conv3_ = conv3x3(f, f)
        self.conv_f = Conv(f, f, 1, 1)
        self.conv4 = Conv(f, N, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c1_ = self.conv1(x)
        v_max = F.max_pool2d(self.conv2(c1_), kernel_size=7, stride=3)
        v_range = F.relu(self.conv_max(v_max))
        c3 = self.conv3_(F.relu(self.conv3(v_range)))
        c3 = F.interpolate(c3, size=x.shape[2:], mode="bilinear",
                           align_corners=False)
        c4 = self.conv4(c3 + self.conv_f(c1_))
        return x * torch.sigmoid(c4)


class SELayer(nn.Module):
    """Squeeze-and-excitation channel gate (reference google.py:1462-1477):
    the mean over H and W, two bias-free dense layers with a ReLU between,
    a sigmoid. No model of the zoo uses it."""

    def __init__(self, channel: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channel, channel // reduction, bias=False), nn.ReLU(),
            Linear(channel // reduction, channel, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]
