"""The benchmark's arithmetic: published peaks, operation counts of the
models' layers from their shapes, the GDN kernels' operations and bytes,
and the quantiles of timings.

Peaks are NVIDIA's data sheet for the H100 SXM5 part (dense, 700 W):
67 TFLOP/s FP32 outside the tensor cores, 989 TFLOP/s bf16, 3.35 TB/s
HBM3. TF32 is off on every measured path (the program's wire
determinism), so an f32 model's share is of the FP32 peak.
"""

from __future__ import annotations

import math
import statistics
from typing import List, Optional, Tuple

import torch
from torch import nn

from benchmark.reference.layers import GDN, MaskedConv

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                              "bytes_per_s": 3.35e12},
}


def peak(device_kind: str, what: str) -> Optional[float]:
    return PEAKS.get(device_kind, {}).get(what)


# -- operations of the models' layers ----------------------------------------


def conv_flops(cin, cout, k_taps, out_pixels) -> int:
    """A convolution: 2 operations a multiply-add of every output pixel,
    output channel, input channel and live kernel tap."""
    return 2 * cin * cout * k_taps * out_pixels


def deconv_flops(cin, cout, k_taps, in_pixels) -> int:
    """A transposed convolution: every input pixel's channels scatter
    through every tap to every output channel."""
    return 2 * cin * cout * k_taps * in_pixels


def gdn_flops(rows, C) -> int:
    """GDN or IGDN forward over (rows, C): the C x C channel product of
    x^2 (2 n C^2) and the square, add, root and scale (4 n C)."""
    return 2 * rows * C * C + 4 * rows * C


def layer_flops(model: nn.Module, run, *inputs) -> Tuple[int, List]:
    """Forward operations of `run(*inputs)` over `model`'s convolutions,
    transposed convolutions and GDNs, counted from the shapes a meta-device
    forward sees: (total, [(layer kind, channels, rows)] of the GDNs in
    call order)."""
    total = [0]
    gdns = []

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, GDN):
            rows = x.shape[0] * x.shape[2] * x.shape[3]
            total[0] += gdn_flops(rows, x.shape[1])
            gdns.append(("igdn" if mod.inverse else "gdn", x.shape[1], rows))
        elif isinstance(mod, nn.ConvTranspose2d):
            taps = mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += deconv_flops(mod.in_channels, mod.out_channels, taps,
                                     x.shape[0] * x.shape[2] * x.shape[3])
        elif isinstance(mod, nn.Conv2d):
            taps = mod.kernel_size[0] * mod.kernel_size[1]
            if isinstance(mod, MaskedConv):
                taps = mod.live_taps
            total[0] += conv_flops(mod.in_channels, mod.out_channels, taps,
                                   out.shape[0] * out.shape[2] * out.shape[3])

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (GDN, nn.Conv2d, nn.ConvTranspose2d))]
    try:
        with torch.no_grad():
            run(*inputs)
    finally:
        for h in handles:
            h.remove()
    return total[0], gdns


# -- the GDN kernels' operations and bytes -----------------------------------
# e: the bytes of an element of the input type; n rows of C channels;
# t = ceil(n / 64) tiles, k = ceil(n / 1024) chunks of the backward.


def gdn_fwd_cost(n, C, e=4) -> Tuple[float, float]:
    """(operations, bytes) of one forward launch: x read and y written
    once, beta and gamma read once."""
    return gdn_flops(n, C), (2 * n * C + C * C + C) * e


def gdn_dx_cost(n, C, e=4) -> Tuple[float, float]:
    """dx: x, g read, dx written, the dn scratch written (f32 4nC, bf16
    2nC and 4tC tile sums), beta and gamma read."""
    scratch = 4 * n * C if e == 4 else 2 * n * C + 4 * math.ceil(n / 64) * C
    return 4 * n * C * C + 12 * n * C, 3 * n * C * e + scratch + (C * C + C) * e


def gdn_partials_cost(n, C, e=4) -> Tuple[float, float]:
    """partials: x and the dn scratch read, 4k(C^2 + C) chunk sums
    written."""
    k = math.ceil(n / 1024)
    if e == 4:
        ops, scratch = 2 * n * C * C + 2 * n * C, 4 * n * C
    else:
        t = math.ceil(n / 64)
        ops, scratch = 2 * n * C * C + n * C + t * C, 2 * n * C + 4 * t * C
    return ops, n * C * e + scratch + 4 * k * (C * C + C)


def gdn_reduce_cost(n, C, e=4) -> Tuple[float, float]:
    """reduce: the k chunk sums read, dbeta and dgamma written."""
    k = math.ceil(n / 1024)
    return k * (C * C + C), 4 * (k + 1) * (C * C + C)


GDN_COSTS = {"gdn_fwd": gdn_fwd_cost, "gdn_bwd_dx": gdn_dx_cost,
             "gdn_bwd_partials": gdn_partials_cost,
             "gdn_bwd_reduce": gdn_reduce_cost}


def bound_s(cost: Tuple[float, float], flops_peak: float,
            bytes_peak: float) -> float:
    """The least time: the larger of operations over the FP peak and bytes
    over the memory bandwidth."""
    ops, nbytes = cost
    return max(ops / flops_peak, nbytes / bytes_peak)


def gdn_class(kernel: str) -> Optional[str]:
    """The launch class of a GDN kernel name (`gdn_fwd_kernel`,
    `gdn_bwd_dx_f32_blocked_kernel`, ...): the C ABI entry point it
    belongs to, or None for any other name."""
    for cls in ("gdn_bwd_partials", "gdn_bwd_reduce", "gdn_bwd_dx",
                "gdn_fwd"):
        if kernel.startswith(cls):
            return cls
    return None


# -- timings ------------------------------------------------------------------


def quantile(values, q: float) -> float:
    """The q-quantile (0 < q < 1) of `values`, linear between order
    statistics (Python's `statistics.quantiles`, method 'inclusive')."""
    values = sorted(values)
    if len(values) == 1:
        return values[0]
    pos = q * (len(values) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(values) - 1)
    return values[lo] + (values[hi] - values[lo]) * (pos - lo)


def spread(values) -> float:
    """Interquartile distance over the median (statistics.quantiles, n=4)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
