"""Entropy models: the factorized EntropyBottleneck and the
GaussianConditional, with their coding tables.

Counterpart of lmic_tpu/entropy/entropy_models.py (reference:
compressai/entropy_models/entropy_models.py:330-740). Tensors are NCHW.

The integer CDF tables are part of the wire: the same weights must give the
same tables wherever the codec runs. So `eb_update` and
`GaussianConditional.update` evaluate their pmfs on the CPU in f32 whatever
the codec's device, and quantize them with the integer-exact ops/cdf.py.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lmic_tpu_torch.entropy import coder
from lmic_tpu_torch.entropy.coder import CdfTable
from lmic_tpu_torch.ops import lower_bound
from lmic_tpu_torch.ops.cdf import batched_pmf_to_quantized_cdf

LIKELIHOOD_BOUND = 1e-9


def quantize_noise(x, generator: Optional[torch.Generator] = None):
    """Additive U(-0.5, 0.5) training proxy for rounding."""
    noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=x.device)
    return x + (noise - 0.5)


def quantize_dequantize(x, means=None):
    """round(x - means) + means (eval-mode forward); half to even."""
    if means is not None:
        return torch.round(x - means) + means
    return torch.round(x)


class EntropyBottleneck(nn.Module):
    """Factorized-prior entropy bottleneck.

    The per-channel cumulative is a 5-stage monotone MLP
    `logits = softplus(H_i) @ logits + b_i (+ tanh(a_i) * tanh(logits))`
    (reference entropy_models.py:457-477), every stage one batched matmul
    over all channels. Parameter names are the reference's
    (`_matrix{i}`, `_bias{i}`, `_factor{i}`, `quantiles`).
    """

    def __init__(self, channels: int, tail_mass: float = 1e-9,
                 init_scale: float = 10.0,
                 filters: Sequence[int] = (3, 3, 3, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels = int(channels)
        self.tail_mass = float(tail_mass)
        self.init_scale = float(init_scale)
        self.filters = tuple(int(f) for f in filters)
        dims = (1,) + self.filters + (1,)
        scale = self.init_scale ** (1 / (len(self.filters) + 1))
        C = self.channels
        for i in range(len(self.filters) + 1):
            init_v = math.log(math.expm1(1 / scale / dims[i + 1]))
            self.register_parameter(f"_matrix{i}", nn.Parameter(
                torch.full((C, dims[i + 1], dims[i]), init_v)
            ))
            bias = torch.rand((C, dims[i + 1], 1), generator=generator) - 0.5
            self.register_parameter(f"_bias{i}", nn.Parameter(bias))
            if i < len(self.filters):
                self.register_parameter(f"_factor{i}", nn.Parameter(
                    torch.zeros((C, dims[i + 1], 1))
                ))
        self.quantiles = nn.Parameter(
            torch.tensor([-self.init_scale, 0.0, self.init_scale])
            .repeat(C, 1, 1)
        )

    def _logits_cumulative(self, inputs, stop_gradient: bool):
        """inputs: (C, 1, N) -> logits (C, 1, N)."""
        logits = inputs
        for i in range(len(self.filters) + 1):
            m = getattr(self, f"_matrix{i}")
            b = getattr(self, f"_bias{i}")
            if stop_gradient:
                m, b = m.detach(), b.detach()
            logits = torch.matmul(F.softplus(m), logits) + b
            if i < len(self.filters):
                f = getattr(self, f"_factor{i}")
                if stop_gradient:
                    f = f.detach()
                logits = logits + torch.tanh(f) * torch.tanh(logits)
        return logits

    def _likelihood(self, inputs):
        lower = self._logits_cumulative(inputs - 0.5, stop_gradient=False)
        upper = self._logits_cumulative(inputs + 0.5, stop_gradient=False)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(
            torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower)
        )

    def aux_loss(self):
        """Drives the quantiles to the tail-mass logit targets (reference
        entropy_models.py:450-454); only `quantiles` learns from it."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        t = math.log(2 / self.tail_mass - 1)
        target = torch.tensor([-t, 0.0, t], dtype=logits.dtype,
                              device=logits.device)
        return torch.abs(logits - target).sum()

    def forward(self, x, training: bool = True,
                generator: Optional[torch.Generator] = None):
        """x: (B, C, ...) NCHW. Returns (x_hat, likelihoods)."""
        C = x.shape[1]
        perm = (1, 0) + tuple(range(2, x.dim()))
        values = x.permute(*perm).reshape(C, 1, -1)
        if training:
            outputs = quantize_noise(values, generator)
        else:
            outputs = quantize_dequantize(values, self.quantiles[:, :, 1:2])
        likelihood = lower_bound(self._likelihood(outputs), LIKELIHOOD_BOUND)
        shape = (C, x.shape[0]) + tuple(x.shape[2:])
        outputs = outputs.reshape(shape).permute(*perm)
        likelihood = likelihood.reshape(shape).permute(*perm)
        return outputs, likelihood

    @torch.no_grad()
    def pmf_data(self):
        """Per-channel pmf over the integer support [median - minima,
        median + maxima] plus tail mass (reference entropy_models.py:396-441),
        evaluated where the module lives. Returns numpy arrays
        (pmf, tail_mass, pmf_length, offset, medians)."""
        q = self.quantiles
        medians = q[:, 0, 1]
        minima = torch.clamp(
            torch.ceil(medians - q[:, 0, 0]).to(torch.int32), min=0
        )
        maxima = torch.clamp(
            torch.ceil(q[:, 0, 2] - medians).to(torch.int32), min=0
        )
        pmf_length = maxima + minima + 1
        max_length = int(pmf_length.max())
        pmf_start = medians - minima
        samples = (
            torch.arange(max_length, dtype=torch.float32,
                         device=q.device)[None, :]
            + pmf_start[:, None, None]
        )  # (C, 1, L)
        lower = self._logits_cumulative(samples - 0.5, stop_gradient=True)
        upper = self._logits_cumulative(samples + 0.5, stop_gradient=True)
        sign = -torch.sign(lower + upper)
        pmf = torch.abs(
            torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower)
        )[:, 0, :]
        tail_mass = (
            torch.sigmoid(lower[:, 0, 0]) + torch.sigmoid(-upper[:, 0, -1])
        )
        return tuple(t.cpu().numpy() for t in
                     (pmf, tail_mass, pmf_length, -minima, medians))


def eb_update(module: EntropyBottleneck) -> "EBState":
    """Build the coder tables for an EntropyBottleneck, on the CPU in f32."""
    cpu = copy.deepcopy(module).to(device="cpu", dtype=torch.float32)
    pmf, tail_mass, pmf_length, offset, medians = cpu.pmf_data()
    cdf = batched_pmf_to_quantized_cdf(
        pmf, tail_mass, pmf_length, int(pmf_length.max())
    )
    return EBState(table=CdfTable(cdf, pmf_length + 2, offset),
                   medians=medians.astype(np.float32))


@dataclasses.dataclass
class EBState:
    """Frozen coding state for one EntropyBottleneck."""

    table: CdfTable
    medians: np.ndarray  # (C,)

    def decode_symbols(self, strings, spatial_shape) -> np.ndarray:
        """The int32 symbols of `strings`, coded channel-major:
        (B, C, *spatial_shape)."""
        C = len(self.medians)
        n = int(np.prod(spatial_shape))
        indexes = np.repeat(np.arange(C, dtype=np.int32), n)
        out = coder.decode_batch(strings, indexes, self.table)
        return out.reshape(len(strings), C, *spatial_shape)


# ---------------------------------------------------------------------------
# Gaussian conditional
# ---------------------------------------------------------------------------

SCALES_MIN = 0.11
SCALES_MAX = 256
SCALES_LEVELS = 64


def get_scale_table(
    minimum=SCALES_MIN, maximum=SCALES_MAX, levels=SCALES_LEVELS
) -> np.ndarray:
    """Log-spaced scale table (reference models/google.py:208-214)."""
    return np.exp(
        np.linspace(math.log(minimum), math.log(maximum), levels)
    ).astype(np.float32)


def _standardized_cumulative(x):
    """Phi(x) via erfc for precision in the tails
    (reference entropy_models.py:629-635)."""
    return 0.5 * torch.special.erfc(-(2**-0.5) * x)


@dataclasses.dataclass(frozen=True)
class GaussianConditional:
    """Zero/known-mean Gaussian conditional likelihood + coding tables.

    Stateless: the scale table lives in the `GCState` that `update()`
    returns. Reference: entropy_models.py:577-740.
    """

    scale_bound: float = 0.11
    tail_mass: float = 1e-9

    def likelihood(self, inputs, scales, means=None):
        values = inputs - means if means is not None else inputs
        scales = lower_bound(scales, self.scale_bound)
        values = torch.abs(values)
        upper = _standardized_cumulative((0.5 - values) / scales)
        lower = _standardized_cumulative((-0.5 - values) / scales)
        return upper - lower

    def __call__(self, inputs, scales, means=None, training=True,
                 generator: Optional[torch.Generator] = None):
        if training:
            outputs = quantize_noise(inputs, generator)
        else:
            outputs = quantize_dequantize(inputs, means)
        likelihood = lower_bound(
            self.likelihood(outputs, scales, means), LIKELIHOOD_BOUND
        )
        return outputs, likelihood

    def build_indexes(self, scale_table, scales):
        """Map each sigma to its scale-table bucket, the reference's counting
        rule (entropy_models.py:735-740):
        index = (L-1) - #{s in table[:-1] : sigma <= s}. int32.

        Given `scale_table` as a tensor on the scales' device, it makes no
        host round trip (the AR codecs call it once per wavefront)."""
        # lower_bound's forward, without a bound tensor made on the host
        scales = torch.clamp_min(scales, self.scale_bound)
        table = torch.as_tensor(scale_table, dtype=scales.dtype,
                                device=scales.device)
        counts = (scales[..., None] <= table[:-1]).sum(-1, dtype=torch.int32)
        return (len(table) - 1) - counts

    def pmf_data(self, scale_table):
        """Per-scale pmf rows, evaluated on the CPU in f32. Returns numpy
        (pmf, tail_mass, pmf_length, offset). Reference:
        entropy_models.py:655-678."""
        # imported here: scipy.stats takes seconds to import, and the
        # processes that only train (data-parallel ranks) build no tables
        import scipy.stats

        scale_table = np.asarray(scale_table, dtype=np.float32)
        multiplier = -scipy.stats.norm.ppf(self.tail_mass / 2)
        pmf_center = np.ceil(scale_table * multiplier).astype(np.int32)
        pmf_length = 2 * pmf_center + 1
        samples = np.abs(
            np.arange(int(pmf_length.max()), dtype=np.int32)
            - pmf_center[:, None]
        ).astype(np.float32)
        scales = scale_table[:, None]
        upper = _standardized_cumulative(
            torch.from_numpy((0.5 - samples) / scales)
        ).numpy()
        lower = _standardized_cumulative(
            torch.from_numpy((-0.5 - samples) / scales)
        ).numpy()
        return upper - lower, 2 * lower[:, 0], pmf_length, -pmf_center

    def update(self, scale_table) -> "GCState":
        """Build integer CDF rows, one per table scale."""
        pmf, tail_mass, pmf_length, offset = self.pmf_data(scale_table)
        cdf = batched_pmf_to_quantized_cdf(
            pmf, tail_mass, pmf_length, int(pmf_length.max())
        )
        return GCState(table=CdfTable(cdf, pmf_length + 2, offset),
                       scale_table=np.asarray(scale_table, np.float32))


@dataclasses.dataclass
class GCState:
    """Frozen coding state for a GaussianConditional."""

    table: CdfTable
    scale_table: np.ndarray
