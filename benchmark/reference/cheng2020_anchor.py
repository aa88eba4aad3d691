"""cheng2020-anchor (Cheng et al. 2020, residual blocks and sub-pixel
convolutions with the joint autoregressive and hierarchical prior;
compressai/models/waseda.py:49-112 over google.py:421-520), plain torch.
M = N, one Gaussian conditional (no mixture), as CompressAI's model."""

from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.entropy import EntropyBottleneck, gaussian_likelihood
from benchmark.reference.layers import (
    Conv,
    LeakyReLU,
    MaskedConv,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SubpelConv,
)


class Model(nn.Module):
    downsampling = 64

    def __init__(self, N: int, M: int):
        super().__init__()
        self.N = self.M = N
        self.g_a = nn.Sequential(
            ResidualBlockWithStride(3, N), ResidualBlock(N, N),
            ResidualBlockWithStride(N, N), ResidualBlock(N, N),
            ResidualBlockWithStride(N, N), ResidualBlock(N, N),
            Conv(N, N, 3, 2))
        self.g_s = nn.Sequential(
            ResidualBlock(N, N), ResidualBlockUpsample(N, N),
            ResidualBlock(N, N), ResidualBlockUpsample(N, N),
            ResidualBlock(N, N), ResidualBlockUpsample(N, N),
            ResidualBlock(N, N), SubpelConv(N, 3, 2))
        self.h_a = nn.Sequential(
            Conv(N, N, 3, 1), LeakyReLU(), Conv(N, N, 3, 1), LeakyReLU(),
            Conv(N, N, 3, 2), LeakyReLU(), Conv(N, N, 3, 1), LeakyReLU(),
            Conv(N, N, 3, 2))
        self.h_s = nn.Sequential(
            Conv(N, N, 3, 1), LeakyReLU(), SubpelConv(N, N, 2), LeakyReLU(),
            Conv(N, N * 3 // 2, 3, 1), LeakyReLU(),
            SubpelConv(N * 3 // 2, N * 3 // 2, 2), LeakyReLU(),
            Conv(N * 3 // 2, N * 2, 3, 1))
        self.entropy_parameters = nn.Sequential(
            Conv(N * 12 // 3, N * 10 // 3, 1, 1), LeakyReLU(),
            Conv(N * 10 // 3, N * 8 // 3, 1, 1), LeakyReLU(),
            Conv(N * 8 // 3, N * 6 // 3, 1, 1))
        self.context_prediction = MaskedConv(N, 2 * N)
        self.entropy_bottleneck = EntropyBottleneck(N)

    def noise_shapes(self, B, H, W):
        """The U(0, 1) draws of a training forward, in order: the
        bottleneck's, the context model's input y_hat, the Gaussian
        conditional's."""
        h, w = H // 64, W // 64
        y = (B, self.M, H // 16, W // 16)
        return [(self.N, 1, B * h * w), y, y]

    def train_forward(self, x, noises):
        y = self.g_a(x)
        z = self.h_a(y)
        z_tilde, z_lik = self.entropy_bottleneck.noisy(z, noises[0])
        params = self.h_s(z_tilde)
        y_hat = y + (noises[1] - 0.5)
        ctx = self.context_prediction(y_hat)
        scales, means = self.entropy_parameters(
            torch.cat([params, ctx], 1)).chunk(2, 1)
        y_tilde = y + (noises[2] - 0.5)
        y_lik = gaussian_likelihood(y_tilde, scales, means)
        return {"x_hat": self.g_s(y_hat),
                "likelihoods": {"y": y_lik, "z": z_lik}}
