"""mbt2018-mean (Minnen, Balle, Toderici 2018, the mean-scale hyperprior;
compressai/models/google.py:348-416), plain torch."""

from __future__ import annotations

from torch import nn

from benchmark.reference.entropy import EntropyBottleneck, gaussian_likelihood
from benchmark.reference.layers import GDN, Conv, Deconv, LeakyReLU


class Model(nn.Module):
    downsampling = 64

    def __init__(self, N: int, M: int):
        super().__init__()
        self.N, self.M = N, M
        self.g_a = nn.Sequential(
            Conv(3, N), GDN(N), Conv(N, N), GDN(N), Conv(N, N), GDN(N),
            Conv(N, M))
        self.g_s = nn.Sequential(
            Deconv(M, N), GDN(N, True), Deconv(N, N), GDN(N, True),
            Deconv(N, N), GDN(N, True), Deconv(N, 3))
        self.h_a = nn.Sequential(
            Conv(M, N, 3, 1), LeakyReLU(), Conv(N, N), LeakyReLU(),
            Conv(N, N))
        self.h_s = nn.Sequential(
            Deconv(N, M), LeakyReLU(), Deconv(M, M * 3 // 2), LeakyReLU(),
            Conv(M * 3 // 2, M * 2, 3, 1))
        self.entropy_bottleneck = EntropyBottleneck(N)

    def noise_shapes(self, B, H, W):
        """The U(0, 1) draws of a training forward, in order: the
        bottleneck's (channel-major) and the Gaussian conditional's."""
        h, w = H // 64, W // 64
        return [(self.N, 1, B * h * w), (B, self.M, H // 16, W // 16)]

    def train_forward(self, x, noises):
        """The training forward on uniform draws `noises` (see
        `noise_shapes`): {"x_hat", "likelihoods": {"y", "z"}}."""
        y = self.g_a(x)
        z = self.h_a(y)
        z_tilde, z_lik = self.entropy_bottleneck.noisy(z, noises[0])
        scales, means = self.h_s(z_tilde).chunk(2, 1)
        y_tilde = y + (noises[1] - 0.5)
        y_lik = gaussian_likelihood(y_tilde, scales, means)
        return {"x_hat": self.g_s(y_tilde),
                "likelihoods": {"y": y_lik, "z": z_lik}}

    def analysis(self, x):
        y = self.g_a(x)
        return y, self.h_a(y)

    def hyper_synthesis(self, z_hat):
        """z_hat -> (scales, means)."""
        return self.h_s(z_hat).chunk(2, 1)
