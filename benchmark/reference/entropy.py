"""Entropy models of the reference, and the integer CDF tables of the
rANS coder, worked out again from the weights.

- `EntropyBottleneck`: CompressAI's factorized density (filters 3, 3, 3,
  3; init scale 10; tail mass 1e-9), its likelihood, its aux loss and its
  per-channel CDF table (entropy_models.py:330-500).
- `gaussian_likelihood`: the Gaussian conditional's likelihood with the
  scale bound 0.11 (entropy_models.py:577-640); `gaussian_tables`: its
  64-scale table and CDF rows.
- `pmf_to_quantized_cdf`: CompressAI's ops.cpp:40-109 (round half up,
  64-bit rescale, zero-width repair by stealing from the smallest
  frequency above one).

The tables are evaluated on the CPU in f32 (`torch.matmul` on the same
shapes as CompressAI's loop), so the same weights give the same integer
tables wherever they are built.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.layers import lower_bound

LIKELIHOOD_BOUND = 1e-9
SCALE_BOUND = 0.11
TAIL_MASS = 1e-9
FILTERS = (3, 3, 3, 3)


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, init_scale: float = 10.0):
        super().__init__()
        C = channels
        dims = (1,) + FILTERS + (1,)
        scale = init_scale ** (1 / (len(FILTERS) + 1))
        for i in range(len(FILTERS) + 1):
            init = math.log(math.expm1(1 / scale / dims[i + 1]))
            self.register_parameter(f"_matrix{i}", nn.Parameter(
                torch.full((C, dims[i + 1], dims[i]), init)))
            self.register_parameter(f"_bias{i}", nn.Parameter(
                torch.zeros(C, dims[i + 1], 1)))
            if i < len(FILTERS):
                self.register_parameter(f"_factor{i}", nn.Parameter(
                    torch.zeros(C, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(
            torch.tensor([-init_scale, 0.0, init_scale]).repeat(C, 1, 1))

    def logits_cumulative(self, x, stop_gradient: bool):
        """x (C, 1, n) -> the cumulative's logits (C, 1, n)."""
        for i in range(len(FILTERS) + 1):
            m = getattr(self, f"_matrix{i}")
            b = getattr(self, f"_bias{i}")
            if stop_gradient:
                m, b = m.detach(), b.detach()
            x = torch.matmul(F.softplus(m), x) + b
            if i < len(FILTERS):
                f = getattr(self, f"_factor{i}")
                if stop_gradient:
                    f = f.detach()
                x = x + torch.tanh(f) * torch.tanh(x)
        return x

    def likelihood(self, values):
        lower = self.logits_cumulative(values - 0.5, False)
        upper = self.logits_cumulative(values + 0.5, False)
        sign = -torch.sign(lower + upper).detach()
        lik = torch.abs(torch.sigmoid(sign * upper)
                        - torch.sigmoid(sign * lower))
        return lower_bound(lik, LIKELIHOOD_BOUND)

    def noisy(self, z, noise):
        """Training: (z + noise - 0.5, likelihood). `noise` is U(0, 1) of
        shape (C, 1, B*h*w), channel-major as CompressAI lays z out."""
        B, C, h, w = z.shape
        values = z.permute(1, 0, 2, 3).reshape(C, 1, -1)
        values = values + (noise - 0.5)
        lik = self.likelihood(values)
        back = (C, B, h, w)
        return (values.reshape(back).permute(1, 0, 2, 3),
                lik.reshape(back).permute(1, 0, 2, 3))

    def aux_loss(self):
        logits = self.logits_cumulative(self.quantiles, True)
        t = math.log(2 / TAIL_MASS - 1)
        target = torch.tensor([-t, 0.0, t], dtype=logits.dtype,
                              device=logits.device)
        return torch.abs(logits - target).sum()

    @torch.no_grad()
    def table(self):
        """(cdf (C, L + 2) int32, cdf_length (C,), offset (C,), medians
        (C,) float32), on the CPU in f32."""
        state = {k: v.detach().to("cpu", torch.float32)
                 for k, v in self.state_dict().items()}
        cpu = EntropyBottleneck(self.quantiles.shape[0])
        cpu.load_state_dict(state)
        q = cpu.quantiles
        medians = q[:, 0, 1]
        minima = torch.clamp(torch.ceil(medians - q[:, 0, 0])
                             .to(torch.int32), min=0)
        maxima = torch.clamp(torch.ceil(q[:, 0, 2] - medians)
                             .to(torch.int32), min=0)
        length = maxima + minima + 1
        start = medians - minima
        samples = (torch.arange(int(length.max()), dtype=torch.float32)
                   [None, :] + start[:, None, None])
        lower = cpu.logits_cumulative(samples - 0.5, True)
        upper = cpu.logits_cumulative(samples + 0.5, True)
        sign = -torch.sign(lower + upper)
        pmf = torch.abs(torch.sigmoid(sign * upper)
                        - torch.sigmoid(sign * lower))[:, 0, :]
        tail = torch.sigmoid(lower[:, 0, 0]) + torch.sigmoid(-upper[:, 0, -1])
        cdf = quantized_rows(pmf.numpy(), tail.numpy(), length.numpy())
        return (cdf, (length.numpy() + 2).astype(np.int32),
                (-minima.numpy()).astype(np.int32),
                medians.numpy().astype(np.float32))


def _phi(x):
    return 0.5 * torch.special.erfc(-(2 ** -0.5) * x)


def gaussian_likelihood(values, scales, means):
    scales = lower_bound(scales, SCALE_BOUND)
    v = torch.abs(values - means)
    lik = _phi((0.5 - v) / scales) - _phi((-0.5 - v) / scales)
    return lower_bound(lik, LIKELIHOOD_BOUND)


def scale_table() -> np.ndarray:
    """64 scales, log-spaced from 0.11 to 256 (google.py:208-214)."""
    return np.exp(np.linspace(math.log(0.11), math.log(256), 64)
                  ).astype(np.float32)


def gaussian_tables(scales: np.ndarray):
    """(cdf, cdf_length, offset) of the Gaussian conditional, one row a
    table scale (entropy_models.py:655-678)."""
    import scipy.stats

    scales = np.asarray(scales, np.float32)
    multiplier = -scipy.stats.norm.ppf(TAIL_MASS / 2)
    center = np.ceil(scales * multiplier).astype(np.int32)
    length = 2 * center + 1
    samples = np.abs(np.arange(int(length.max()), dtype=np.int32)
                     - center[:, None]).astype(np.float32)
    s = scales[:, None]
    upper = _phi(torch.from_numpy((0.5 - samples) / s)).numpy()
    lower = _phi(torch.from_numpy((-0.5 - samples) / s)).numpy()
    cdf = quantized_rows(upper - lower, 2 * lower[:, 0], length)
    return cdf, (length + 2).astype(np.int32), (-center).astype(np.int32)


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    pmf = np.asarray(pmf, dtype=np.float32)
    one = 1 << precision
    freq = np.floor((pmf * np.float32(one)).astype(np.float64) + 0.5
                    ).astype(np.int64)
    freq = (one * freq) // int(freq.sum())
    cdf = np.zeros(len(pmf) + 1, dtype=np.int64)
    np.cumsum(freq, out=cdf[1:])
    cdf[-1] = one
    for i in range(len(pmf)):
        if cdf[i] != cdf[i + 1]:
            continue
        f = np.diff(cdf)
        cand = np.where(f > 1)[0]
        steal = cand[np.argmin(f[cand])]
        if steal < i:
            cdf[steal + 1:i + 1] -= 1
        else:
            cdf[i + 1:steal + 1] += 1
    return cdf.astype(np.int32)


def quantized_rows(pmf, tail, length) -> np.ndarray:
    """Row i: the CDF of pmf[i, :length[i]] followed by tail[i], padded
    with zeros to the longest row + 2."""
    length = np.asarray(length).astype(np.int64)
    out = np.zeros((len(length), int(length.max()) + 2), np.int32)
    for i, n in enumerate(length):
        row = pmf_to_quantized_cdf(np.concatenate([pmf[i, :n], tail[i:i + 1]]))
        out[i, :len(row)] = row
    return out
