"""Cheng2020 anchor / attention models.

Counterpart of lmic_tpu/models/cheng.py:32-111 (reference
compressai/models/waseda.py:49-158): residual-block transforms with
sub-pixel upsampling in place of the conv-GDN stacks, the attention
variant with Cheng2020's sigmoid-gated attention blocks. Both inherit the
mbt2018 entropy path (context model, entropy parameters, the wavefront
codec) with M = N, and the single Gaussian conditional (no GMM), as the
vendored reference and lmic_tpu have it.
"""

from __future__ import annotations

from torch import nn

from lmic_tpu_torch.layers import (
    AttentionBlock,
    Block,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SubpelConv3x3,
    conv3x3,
)
from lmic_tpu_torch.models.joint import JointAutoregressiveHierarchicalPriors


def _leaky():
    return nn.LeakyReLU(0.01)


class Cheng2020Anchor(JointAutoregressiveHierarchicalPriors):
    """cheng2020-anchor: M = N; residual and sub-pixel transforms."""

    @staticmethod
    def _make_g_a(channel, N, M, dt):
        return nn.Sequential(
            ResidualBlockWithStride(channel, N, stride=2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockWithStride(N, N, stride=2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockWithStride(N, N, stride=2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            conv3x3(N, N, stride=2, dtype=dt),
        )

    @staticmethod
    def _make_g_s(channel, N, M, dt):
        return nn.Sequential(
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockUpsample(N, N, 2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockUpsample(N, N, 2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockUpsample(N, N, 2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            SubpelConv3x3(N, channel, 2, dtype=dt),
        )

    @staticmethod
    def _make_h_a(N, M, dt):
        return Block(
            conv3x3(N, N, dtype=dt), _leaky(),
            conv3x3(N, N, dtype=dt), _leaky(),
            conv3x3(N, N, stride=2, dtype=dt), _leaky(),
            conv3x3(N, N, dtype=dt), _leaky(),
            conv3x3(N, N, stride=2, dtype=dt),
        )

    @staticmethod
    def _make_h_s(N, M, dt):
        return Block(
            conv3x3(N, N, dtype=dt), _leaky(),
            SubpelConv3x3(N, N, 2, dtype=dt), _leaky(),
            conv3x3(N, N * 3 // 2, dtype=dt), _leaky(),
            SubpelConv3x3(N * 3 // 2, N * 3 // 2, 2, dtype=dt), _leaky(),
            conv3x3(N * 3 // 2, N * 2, dtype=dt),
        )


class Cheng2020Attention(Cheng2020Anchor):
    """cheng2020-attn: attention blocks in g_a and g_s."""

    @staticmethod
    def _make_g_a(channel, N, M, dt):
        return nn.Sequential(
            ResidualBlockWithStride(channel, N, stride=2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockWithStride(N, N, stride=2, dtype=dt),
            AttentionBlock(N, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockWithStride(N, N, stride=2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            conv3x3(N, N, stride=2, dtype=dt),
            AttentionBlock(N, dtype=dt),
        )

    @staticmethod
    def _make_g_s(channel, N, M, dt):
        return nn.Sequential(
            AttentionBlock(N, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockUpsample(N, N, 2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockUpsample(N, N, 2, dtype=dt),
            AttentionBlock(N, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            ResidualBlockUpsample(N, N, 2, dtype=dt),
            ResidualBlock(N, N, dtype=dt),
            SubpelConv3x3(N, channel, 2, dtype=dt),
        )
