"""The paired RGB-T archs: `_R` codecs of the guide modality that emit
their hidden maps, and `_D` codecs of the dependent (thermal, 1-channel)
modality that fuse those maps in at every transform level.

Counterpart of lmic_tpu/models/rgbt_joint.py (reference
compressai/models/google.py:696-1477, waseda.py:162-694):

- `JointAutoregressiveHierarchicalPriors_R`: the port's `GuidedCompresser`
  (mbt2018 with the `ga1..3`/`gs1..3` taps), unchanged;
- `Cheng2020Anchor_R`: the same transforms with cheng2020's hyper pair;
- `Cheng2020Attention_R`: cheng2020-attn's residual/attention transforms
  with taps (`ChengEncoderHidden`, `ChengDecoderHidden`);
- `JointAutoregressiveHierarchicalPriors_D`, `Cheng2020Anchor_D`,
  `Cheng2020Attention_D`: at each of three levels of g_a and of g_s, an
  `_EdgeFuse` of the master stream and the guide's map of that level,
  concatenated back into the main path;
- `FusedARCodec`: the `_D` codec on mbt2018's wavefront machinery,
  `compress(x, hidden)` reading the `ga*` maps and
  `decompress(strings, shape, hidden)` the `gs*` maps.

Parameter names are CompressAI's (`pic2_g_a_conv1`, `eg_ext3.0`,
`tran_conv2`, `attention4.conv_max`, `enc.res_stride1`, `g_a_rbs2`, ...),
the names lmic_tpu's importers read (lmic_tpu/zoo/pretrained.py:743-921).
The `_D` modules build only what their forward runs: CompressAI's unused
inherited `g_a`/`g_s` (and cheng2020-attn_D's `pic2_*`) have no params in
lmic_tpu, and none here. Every GDN/IGDN is `layers.GDN`, so the CUDA
`gdn_fwd` kernel on the card.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from lmic_tpu_torch.layers import (
    ESA,
    GDN,
    AttentionBlock,
    Conv,
    Deconv,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SubpelConv3x3,
    conv3x3,
)
from lmic_tpu_torch.models.cheng import Cheng2020Anchor
from lmic_tpu_torch.models.codec import _image_out, _symbols_to_host
from lmic_tpu_torch.models.joint import JointARCodec
from lmic_tpu_torch.models.rgbt import GuidedCompresser
from lmic_tpu_torch.ops.math import from_amp
from lmic_tpu_torch.utils.determinism import set_wire_determinism


class JointAutoregressiveHierarchicalPriors_R(GuidedCompresser):
    """mbt2018 guide codec with hidden taps (google.py:746-1003): the
    paper's Guided_compresser."""


class Cheng2020Anchor_R(JointAutoregressiveHierarchicalPriors_R):
    """The GDN transforms with cheng2020's hyper pair (waseda.py:162-209)."""

    _make_h_a = staticmethod(Cheng2020Anchor._make_h_a)
    _make_h_s = staticmethod(Cheng2020Anchor._make_h_s)


class ChengEncoderHidden(nn.Module):
    """cheng2020-attn's analysis with taps (waseda.py:409-433): returns
    (y, h1, h2, h3). As in lmic_tpu, the last strided conv reads
    `res_stride3`'s output; `res3` makes the tap h3 only."""

    def __init__(self, channel: int, N: int):
        super().__init__()
        self.res_stride1 = ResidualBlockWithStride(channel, N, 2)
        self.res1 = ResidualBlock(N, N)
        self.res_stride2 = ResidualBlockWithStride(N, N, 2)
        self.atten1 = AttentionBlock(N)
        self.res2 = ResidualBlock(N, N)
        self.res_stride3 = ResidualBlockWithStride(N, N, 2)
        self.res3 = ResidualBlock(N, N)
        self.conv = conv3x3(N, N, stride=2)
        self.atten2 = AttentionBlock(N)

    def forward(self, x):
        h1 = self.res1(self.res_stride1(x))
        h2 = self.res2(self.atten1(self.res_stride2(h1)))
        x = self.res_stride3(h2)
        h3 = self.res3(x)
        return self.atten2(self.conv(x)), h1, h2, h3


class ChengDecoderHidden(nn.Module):
    """cheng2020-attn's synthesis with taps (waseda.py:436-460): returns
    (x_hat, h1, h2, h3)."""

    def __init__(self, channel: int, N: int):
        super().__init__()
        self.atten1 = AttentionBlock(N)
        self.res1 = ResidualBlock(N, N)
        self.res_stride1 = ResidualBlockUpsample(N, N, 2)
        self.res2 = ResidualBlock(N, N)
        self.res_stride2 = ResidualBlockUpsample(N, N, 2)
        self.atten2 = AttentionBlock(N)
        self.res3 = ResidualBlock(N, N)
        self.res_stride3 = ResidualBlockUpsample(N, N, 2)
        self.res4 = ResidualBlock(N, N)
        self.conv = SubpelConv3x3(N, channel, 2)

    def forward(self, y_hat):
        h1 = self.res_stride1(self.res1(self.atten1(y_hat)))
        h2 = self.atten2(self.res_stride2(self.res2(h1)))
        h3 = self.res_stride3(self.res3(h2))
        return self.conv(self.res4(h3)), h1, h2, h3


class Cheng2020Attention_R(Cheng2020Anchor_R):
    """cheng2020-attn's transforms with taps (waseda.py:212-261), under
    CompressAI's `enc`/`dec`. `first_stride` sets only the downsampling
    factor here, as in lmic_tpu: the encoder's first block is at stride
    2."""

    _transform_names = ("enc", "dec")

    def _make_g_a(self, channel, N, M, dt):
        return ChengEncoderHidden(channel, N)

    def _make_g_s(self, channel, N, M, dt):
        return ChengDecoderHidden(channel, N)


class _EdgeFuse:
    """One fusion level (google.py:1150-1157): relu(conv3x3) of the master
    stream and of the guide's map, concatenated, a 5x5 stride-1 conv
    (2N -> N), then ESA. Its layers are the model's, under CompressAI's
    names (`eg_ext{k}`, `tran_conv{k}`, `attention{k}`), so it registers
    none itself."""

    def __init__(self, eg_x: nn.Module, eg_h: nn.Module, tran: nn.Module,
                 esa: nn.Module):
        self.eg_x, self.eg_h, self.tran, self.esa = eg_x, eg_h, tran, esa

    def __call__(self, x, hidden_map):
        eg = torch.cat([self.eg_x(x), self.eg_h(hidden_map)], dim=1)
        return self.esa(self.tran(eg))


class JointAutoregressiveHierarchicalPriors_D(GuidedCompresser):
    """Hidden-consuming mbt2018 for the dependent modality
    (google.py:1006-1423): `forward(x, hidden)` with hidden = {ga1..3,
    gs1..3} of the `_R` model, at the master's own pyramid (a same-size
    pair, the `_R` first conv at stride 2)."""

    # the fused stacks replace the inherited transforms
    _transform_names = ()

    def __init__(self, N: int, M: int, channel: int = 3,
                 first_stride: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(N, M, channel=channel, first_stride=first_stride,
                         generator=generator, dtype=dtype)
        self._make_fused(self.channel, self.N, self.M)
        N = self.N
        for k in range(1, 13):
            setattr(self, f"eg_ext{k}",
                    nn.Sequential(conv3x3(N, N), nn.ReLU()))
        for k in range(1, 7):
            setattr(self, f"tran_conv{k}", Conv(2 * N, N, 5, 1))
            setattr(self, f"attention{k}", ESA(N))
        # level i of g_a fuses with eg_ext 2i+1, 2i+2, tran_conv and
        # attention i+1; of g_s with 2i+7, 2i+8 and i+4 (the reference's
        # wiring, google.py:1158-1242)
        self.enc_fuse = [self._level(k) for k in range(3)]
        self.dec_fuse = [self._level(k) for k in range(3, 6)]

    def _level(self, k: int) -> _EdgeFuse:
        return _EdgeFuse(getattr(self, f"eg_ext{2 * k + 1}"),
                         getattr(self, f"eg_ext{2 * k + 2}"),
                         getattr(self, f"tran_conv{k + 1}"),
                         getattr(self, f"attention{k + 1}"))

    def _make_fused(self, channel, N, M):
        for i, (c_in, c_out) in enumerate(
                ((channel, N), (2 * N, N), (2 * N, N), (2 * N, M))):
            setattr(self, f"pic2_g_a_conv{i + 1}", Conv(c_in, c_out))
        for i, (c_in, c_out) in enumerate(
                ((M, N), (2 * N, N), (2 * N, N), (2 * N, channel))):
            setattr(self, f"pic2_g_s_conv{i + 1}", Deconv(c_in, c_out))
        for i in range(1, 4):
            setattr(self, f"pic2_g_a_gdn{i}", GDN(N))
            setattr(self, f"pic2_g_s_gdn{i}", GDN(N, inverse=True))

    def g_a(self, x):
        raise NotImplementedError("a `_D` model analyzes with the guide's "
                                  "maps: g_a_fused / analyze_fused")

    def g_s(self, y_hat):
        raise NotImplementedError("a `_D` model synthesizes with the "
                                  "guide's maps: g_s_fused")

    def _fused(self, side, x, hidden, key, fuse):
        """Conv + GDN, then per level: fuse with the map, concatenate,
        conv; a GDN after every conv but the last."""
        x = getattr(self, f"pic2_g_{side}_gdn1")(
            getattr(self, f"pic2_g_{side}_conv1")(x))
        for i in range(3):
            f = fuse[i](x, hidden[f"{key}{i + 1}"])
            x = getattr(self, f"pic2_g_{side}_conv{i + 2}")(
                torch.cat([x, f], dim=1))
            if i < 2:
                x = getattr(self, f"pic2_g_{side}_gdn{i + 2}")(x)
        return x

    def g_a_fused(self, x, hidden):
        """x and the guide encoder's ga1..3 -> y."""
        return self._fused("a", x, hidden, "ga", self.enc_fuse)

    def g_s_fused(self, y_hat, hidden):
        """y_hat and the guide decoder's gs1..3 -> x_hat."""
        return self._fused("s", y_hat, hidden, "gs", self.dec_fuse)

    def analyze_fused(self, x, hidden):
        y = from_amp(self.g_a_fused(x, hidden))
        return y, from_amp(self.h_a(y))

    def forward(self, x, hidden, training: bool = True,
                generator: Optional[torch.Generator] = None):
        out = self._entropy_forward(from_amp(self.g_a_fused(x, hidden)),
                                    training, generator)
        return {"x_hat": from_amp(self.g_s_fused(out.pop("y_hat"), hidden)),
                "likelihoods": out["likelihoods"]}


class Cheng2020Anchor_D(JointAutoregressiveHierarchicalPriors_D):
    """The fused GDN transforms with cheng2020's hyper pair
    (waseda.py:463-530)."""

    _make_h_a = staticmethod(Cheng2020Anchor._make_h_a)
    _make_h_s = staticmethod(Cheng2020Anchor._make_h_s)


class Cheng2020Attention_D(Cheng2020Anchor_D):
    """Residual/attention fused transforms (waseda.py:533-694); the blocks
    after a fusion read the 2N-channel concatenation."""

    def _make_fused(self, channel, N, M):
        self.g_a_rbs1 = ResidualBlockWithStride(channel, N, 2)
        self.g_a_rb1 = ResidualBlock(N, N)
        self.g_a_rbs2 = ResidualBlockWithStride(2 * N, N, 2)
        self.g_a_att1 = AttentionBlock(N)
        self.g_a_rb2 = ResidualBlock(N, N)
        self.g_a_rbs3 = ResidualBlockWithStride(2 * N, N, 2)
        self.g_a_rb3 = ResidualBlock(N, N)
        self.g_a_conv = conv3x3(2 * N, N, stride=2)
        self.g_a_att2 = AttentionBlock(N)
        self.g_s_att1 = AttentionBlock(N)
        self.g_s_rb1 = ResidualBlock(N, N)
        self.g_s_rbs1 = ResidualBlockUpsample(N, N, 2)
        self.g_s_rb2 = ResidualBlock(2 * N, N)
        self.g_s_rbs2 = ResidualBlockUpsample(N, N, 2)
        self.g_s_att2 = AttentionBlock(N)
        self.g_s_rb3 = ResidualBlock(2 * N, N)
        self.g_s_rbs3 = ResidualBlockUpsample(N, N, 2)
        self.g_s_rb4 = ResidualBlock(2 * N, N)
        self.g_s_conv = SubpelConv3x3(N, channel, 2)

    def g_a_fused(self, x, hidden):
        x = self.g_a_rb1(self.g_a_rbs1(x))
        f = self.enc_fuse[0](x, hidden["ga1"])
        x = self.g_a_rb2(self.g_a_att1(self.g_a_rbs2(torch.cat([x, f], 1))))
        f = self.enc_fuse[1](x, hidden["ga2"])
        x = self.g_a_rb3(self.g_a_rbs3(torch.cat([x, f], 1)))
        f = self.enc_fuse[2](x, hidden["ga3"])
        return self.g_a_att2(self.g_a_conv(torch.cat([x, f], 1)))

    def g_s_fused(self, y_hat, hidden):
        x = self.g_s_rbs1(self.g_s_rb1(self.g_s_att1(y_hat)))
        f = self.dec_fuse[0](x, hidden["gs1"])
        x = self.g_s_att2(self.g_s_rbs2(self.g_s_rb2(torch.cat([x, f], 1))))
        f = self.dec_fuse[1](x, hidden["gs2"])
        x = self.g_s_rbs3(self.g_s_rb3(torch.cat([x, f], 1)))
        f = self.dec_fuse[2](x, hidden["gs3"])
        return self.g_s_conv(self.g_s_rb4(torch.cat([x, f], 1)))


class FusedARCodec(JointARCodec):
    """The `_D` archs' codec (lmic_tpu/models/rgbt_joint.py:278). The
    guide's maps are the `_R` codec's, as `GuidedCodec` returns them:
    (B, C, H, W) float32 tensors, `compress`'s "hidden" (ga1..3) for the
    encoder and `decompress`'s (gs1..3) for the decoder. The entropy path
    is mbt2018's wavefront codec; the fused analysis runs one image at a
    time, with the maps sliced per image."""

    def _maps(self, hidden, prefix: str) -> Dict[str, torch.Tensor]:
        return {k: v.to(self.device, torch.float32)
                for k, v in hidden.items() if k.startswith(prefix)}

    @torch.inference_mode()
    def compress(self, x, hidden):
        """x: (B, H, W, C) float in [0, 1] or uint8; `hidden`: the guide
        encoder's maps."""
        self._check_updated()
        x = np.asarray(x)
        self._check_dims(x)
        set_wire_determinism()
        t0 = time.perf_counter()
        ga = self._maps(hidden, "ga")
        z_med = self._medians(self.eb_state)
        ys, z_syms = [], []
        for i in range(x.shape[0]):
            y, z = self.module.analyze_fused(
                self._pixels(x[i:i + 1]),
                {k: v[i:i + 1] for k, v in ga.items()})
            ys.append(y)
            z_syms.append(_symbols_to_host(torch.round(z - z_med)))
        self._stat("enc_analysis_ms", t0)
        return self._code_y_z(ys, np.concatenate(z_syms))

    @torch.inference_mode()
    def decompress(self, strings, shape, hidden, u8: bool = False):
        """`hidden`: the guide decoder's maps. -> {"x_hat": (B, H, W, C)
        numpy in [0, 1], uint8 levels when `u8`}."""
        self._check_updated()
        set_wire_determinism()
        y_hat = self._decode_y_hat(strings, shape)
        t0 = time.perf_counter()
        x_hat = self.module.g_s_fused(
            y_hat.contiguous(memory_format=torch.channels_last),
            self._maps(hidden, "gs"))
        out = _image_out(x_hat, u8)
        self._stat("dec_synthesis_ms", t0)
        return out
