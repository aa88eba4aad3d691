"""Image codec transform networks (NCHW, channels_last).

Counterpart of lmic_tpu/models/image.py (reference compressai/models/
google.py):

- `FactorizedPrior`        (bmshj2018-factorized, google.py:127-204)
- `ScaleHyperprior`        (bmshj2018-hyperprior, google.py:218-344)
- `MeanScaleHyperprior`    (mbt2018-mean,         google.py:348-416)

`nn.Sequential` indices follow the reference (`g_a.0..6`, `g_s.0..6`,
`h_a.0..4`, `h_s.0..5`), so `state_dict()` keys are CompressAI's keys. The
split sub-network methods (`g_a`, `g_s`, `analyze`, `hyper_to_params`) are
what the codec wrappers in models/codec.py run.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from lmic_tpu_torch.entropy.entropy_models import (
    EntropyBottleneck,
    GaussianConditional,
)
from lmic_tpu_torch.layers import GDN, Block, Conv, Deconv, GDNStack
from lmic_tpu_torch.ops.math import from_amp


def _g_a(channel: int, N: int, M: int, dt) -> GDNStack:
    return GDNStack(
        Conv(channel, N, dtype=dt), GDN(N, dtype=dt),
        Conv(N, N, dtype=dt), GDN(N, dtype=dt),
        Conv(N, N, dtype=dt), GDN(N, dtype=dt),
        Conv(N, M, dtype=dt),
    )


def _g_s(channel: int, N: int, M: int, dt) -> GDNStack:
    return GDNStack(
        Deconv(M, N, dtype=dt), GDN(N, inverse=True, dtype=dt),
        Deconv(N, N, dtype=dt), GDN(N, inverse=True, dtype=dt),
        Deconv(N, N, dtype=dt), GDN(N, inverse=True, dtype=dt),
        Deconv(N, channel, dtype=dt),
    )


class FactorizedPrior(nn.Module):
    """4x (conv s2 + GDN) analysis / mirrored synthesis, factorized prior.

    `dtype` is the activation compute dtype (torch.bfloat16 for AMP
    training): convs and GDN run in it while the parameters and all
    entropy/likelihood math stay f32, with `from_amp` casts at the entropy
    and loss boundaries. Leave None (f32) for codec wires: the bitstream
    formats assume f32 transforms.
    """

    downsampling_factor = 2**4

    def __init__(self, N: int, M: int, channel: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.N, self.M, self.channel = int(N), int(M), int(channel)
        self.dtype = dtype
        self.g_a = _g_a(channel, N, M, dtype)
        self.g_s = _g_s(channel, N, M, dtype)
        self.entropy_bottleneck = EntropyBottleneck(M, generator=generator)

    def forward(self, x, training: bool = True,
                generator: Optional[torch.Generator] = None):
        y = from_amp(self.g_a(x))
        y_hat, y_likelihoods = self.entropy_bottleneck(
            y, training=training, generator=generator
        )
        x_hat = from_amp(self.g_s(y_hat))
        return {"x_hat": x_hat, "likelihoods": {"y": y_likelihoods}}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


class ScaleHyperprior(nn.Module):
    """Hyperprior model: h_a(|y|) -> z; h_s(z_hat) -> sigma for the Gaussian
    conditional on y. Reference google.py:218-344."""

    downsampling_factor = 2**6

    def __init__(self, N: int, M: int, channel: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.N, self.M, self.channel = int(N), int(M), int(channel)
        self.dtype = dtype  # see FactorizedPrior
        for name, make in zip(self._transform_names,
                              (self._make_g_a, self._make_g_s)):
            setattr(self, name, make(channel, N, M, dtype))
        self.h_a = self._make_h_a(N, M, dtype)
        self.h_s = self._make_h_s(N, M, dtype)
        self.entropy_bottleneck = EntropyBottleneck(N, generator=generator)
        self.gaussian_conditional = GaussianConditional()

    # the four transform stacks; the AR family's subclasses replace them.
    # The analysis and synthesis stacks are attributes of these names (the
    # RGB-T pair keeps CompressAI's `enc1`/`dec1` and `g_a`/`decoder`;
    # the `_D` archs build their own fused stacks, and name none)
    _transform_names = ("g_a", "g_s")
    _make_g_a = staticmethod(_g_a)
    _make_g_s = staticmethod(_g_s)

    @staticmethod
    def _make_h_a(N, M, dt):
        return Block(
            Conv(M, N, kernel_size=3, stride=1, dtype=dt), nn.ReLU(),
            Conv(N, N, dtype=dt), nn.ReLU(),
            Conv(N, N, dtype=dt),
        )

    @staticmethod
    def _make_h_s(N, M, dt):
        return Block(
            Deconv(N, N, dtype=dt), nn.ReLU(),
            Deconv(N, N, dtype=dt), nn.ReLU(),
            Conv(N, M, kernel_size=3, stride=1, dtype=dt), nn.ReLU(),
        )

    def _hyper_input(self, y):
        return torch.abs(y)

    def hyper_to_params(self, z_hat):
        """z_hat -> (scales, means). Shared by encode and decode, so the
        scale-bucket indexes are derived by one code path on both sides."""
        return from_amp(self.h_s(z_hat)), None

    def analyze(self, x):
        """Encoder transform pass: (y, z)."""
        y = from_amp(self.g_a(x))
        z = from_amp(self.h_a(self._hyper_input(y)))
        return y, z

    def forward(self, x, training: bool = True,
                generator: Optional[torch.Generator] = None):
        y, z = self.analyze(x)
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator
        )
        scales_hat, means_hat = self.hyper_to_params(z_hat)
        y_hat, y_likelihoods = self.gaussian_conditional(
            y, scales_hat, means=means_hat, training=training,
            generator=generator,
        )
        x_hat = from_amp(self.g_s(y_hat))
        return {
            "x_hat": x_hat,
            "likelihoods": {"y": y_likelihoods, "z": z_likelihoods},
        }

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


class MeanScaleHyperprior(ScaleHyperprior):
    """Hyperprior emitting (sigma, mu) — mbt2018-mean.
    Reference google.py:348-416."""

    @staticmethod
    def _make_h_a(N, M, dt):
        return Block(
            Conv(M, N, kernel_size=3, stride=1, dtype=dt), nn.LeakyReLU(0.01),
            Conv(N, N, dtype=dt), nn.LeakyReLU(0.01),
            Conv(N, N, dtype=dt),
        )

    @staticmethod
    def _make_h_s(N, M, dt):
        return Block(
            Deconv(N, M, dtype=dt), nn.LeakyReLU(0.01),
            Deconv(M, M * 3 // 2, dtype=dt), nn.LeakyReLU(0.01),
            Conv(M * 3 // 2, M * 2, kernel_size=3, stride=1, dtype=dt),
        )

    def _hyper_input(self, y):
        return y  # no abs for the mean-scale variant

    def hyper_to_params(self, z_hat):
        scales, means = from_amp(self.h_s(z_hat)).chunk(2, dim=1)
        return scales, means
