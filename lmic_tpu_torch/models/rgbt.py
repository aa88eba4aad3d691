"""The RGB-T multi-modality pair: the guided codec and the master codec
conditioned on the guide's reconstruction.

Counterpart of lmic_tpu/models/rgbt.py (reference compressai/models/
master.py, CVPR'22 "Learning based Multi-modality Image and Video
Compression"):

- `GuidedCompresser`: mbt2018 for the guide modality, its encoder and
  decoder tapping the three GDN/IGDN maps (`ga1..3`, `gs1..3`);
- `MasterCompresser`: codes the master modality. Feature encoders bring
  both modalities to one 64-channel grid; a `ChannelAligner` computes a
  per-channel affine (beta, gamma) of the guide feature, transmitted as
  side info; the decoder fuses the guide's decoder maps through three
  Swin-style windowed cross-attention `SpatialAligner`s (q from the
  master, k and v from the guide).

Module and parameter names are CompressAI's (`enc1.g_a_conv1`,
`decoder.sp_aligner1.blocks.0.attn.qkv1`, `ch_aligner.conv5`, ...), the
names lmic_tpu's importer reads (lmic_tpu/zoo/pretrained.py:567-740).

The Swin pieces run on (B, H, W, C) tokens as lmic_tpu's do, in plain
torch products and `softmax` in lmic_tpu's order of operations (no
`scaled_dot_product_attention`); lmic_tpu has no hand kernel for them.
The patch embeds (k = s = 2, no padding) and the recovery (a transposed
k = s = 2 conv, padding 0, output padding 0) are `layers.Conv2d` /
`ConvTranspose2d`: `layers.Conv`/`Deconv` pad k//2 and add s - 1 of
output padding, and these stride-2 layers need neither their compute
dtype (the pair's wire is f32) nor the GEMM route of stride-1 convs.
Under the bf16 mode (`ops/precision.py`, `eval_model --half`) the Swin
pieces' dense layers, `q @ k^T`, `attn @ v`, the patch embeds and the
recovery round their operands as lmic_tpu's do; the softmax, the norms
and the bias tables stay f32.

`SpatialAligner` reproduces the reference's raw `view(B, C, H', W')` of
the (B, L, C) token sequence (master.py:738-739), a layout scramble that
trained weights learned around: do not turn it into a transpose.
Every GDN/IGDN is `layers.GDN`, so the CUDA `gdn_fwd` kernel on the card.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lmic_tpu_torch.layers import (
    GDN,
    Conv,
    Conv2d,
    ConvTranspose2d,
    Deconv,
    GDNStack,
    Linear,
    ResidualBlock,
    conv1x1,
    remat,
)
from lmic_tpu_torch.models.codec import _image_out, _symbols_to_host
from lmic_tpu_torch.models.joint import (
    JointARCodec,
    JointAutoregressiveHierarchicalPriors,
)
from lmic_tpu_torch.ops import precision
from lmic_tpu_torch.ops.math import from_amp
from lmic_tpu_torch.utils.determinism import set_wire_determinism


def _leaky(x):
    return F.leaky_relu(x, 0.01)


# ---------------------------------------------------------------------------
# Feature-space encoders / decoders (master.py:68-118)
# ---------------------------------------------------------------------------


# the width of the feature grid both modalities meet on, and of beta/gamma
FEATURES = 64


class FeatureEncoder(nn.Module):
    """conv3x3(stride) to FEATURES channels + 3 residual blocks with a long
    skip."""

    def __init__(self, in_channels: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv(in_channels, FEATURES, 3, stride)
        self.resblock1 = ResidualBlock(FEATURES, FEATURES)
        self.resblock2 = ResidualBlock(FEATURES, FEATURES)
        self.resblock3 = ResidualBlock(FEATURES, FEATURES)

    def forward(self, x):
        return remat.run(self._forward, x)

    def _forward(self, x):
        out = self.conv1(x)
        return self.resblock3(self.resblock2(self.resblock1(out))) + out


class FeatureDecoder(nn.Module):
    """3 residual blocks (the first from `in_channels` to FEATURES, with
    its 1x1 skip) + a 1x1 long skip, then a transposed conv to image
    space."""

    def __init__(self, in_channels: int, out_channels: int, stride: int):
        super().__init__()
        self.resblock1 = ResidualBlock(in_channels, FEATURES)
        self.resblock2 = ResidualBlock(FEATURES, FEATURES)
        self.resblock3 = ResidualBlock(FEATURES, FEATURES)
        self.conv = conv1x1(in_channels, FEATURES)
        self.deconv1 = Deconv(FEATURES, out_channels, 3, stride)

    def forward(self, x):
        return remat.run(self._forward, x)

    def _forward(self, x):
        out = self.resblock3(self.resblock2(self.resblock1(x)))
        return self.deconv1(out + self.conv(x))


class ChannelAligner(nn.Module):
    """Channel-wise affine alignment of the guide feature (master.py:
    158-210): a 4-conv 256-channel trunk SHARED by the two branches; conv5
    gives beta from the master feature, conv6 gamma from the guide
    feature, each averaged over the grid to (B, FEATURES, 1, 1)."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(FEATURES, 256, 3, 1)
        self.conv2 = Conv(256, 256, 3, 1)
        self.conv3 = Conv(256, 256, 3, 1)
        self.conv4 = Conv(256, 256, 3, 1)
        self.conv5 = Conv(256, FEATURES, 3, 1)
        self.conv6 = Conv(256, FEATURES, 3, 1)

    def _trunk(self, f):
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            f = _leaky(conv(f))
        return f

    def forward(self, x_feature, guided_feature):
        """-> (gamma * guided_feature + beta, beta, gamma)."""
        beta = remat.run(self._branch, self.conv5, x_feature)
        gamma = remat.run(self._branch, self.conv6, guided_feature)
        return gamma * guided_feature + beta, beta, gamma

    def _branch(self, head, f):
        """The trunk, a head and the mean over the grid: one block of
        `remat` a branch, so a recompute rebuilds one trunk at a time
        (eight 256-channel maps, 2.7 GB a sample at 512x640)."""
        return head(self._trunk(f)).mean((2, 3), keepdim=True)


# ---------------------------------------------------------------------------
# Swin-style guided cross-attention (master.py:386-742)
# ---------------------------------------------------------------------------


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws*ws, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def window_reverse(windows: torch.Tensor, ws: int, H: int, W: int
                   ) -> torch.Tensor:
    """(B * nW, ws*ws, C) -> (B, H, W, C)."""
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def _relative_position_index(ws: int) -> np.ndarray:
    """Static (ws*ws, ws*ws) index into the (2ws-1)^2 bias table
    (master.py:512-523)."""
    coords = np.stack(
        np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws*ws, ws*ws) additive mask for shifted windows
    (master.py:627-645)."""
    img_mask = np.zeros((H, W), np.float32)
    slices = (
        slice(0, -ws),
        slice(-ws, -shift),
        slice(-shift, None),
    )
    cnt = 0
    for h in slices:
        for w in slices:
            img_mask[h, w] = cnt
            cnt += 1
    mask_windows = (
        img_mask.reshape(H // ws, ws, W // ws, ws)
        .transpose(0, 2, 1, 3)
        .reshape(-1, ws * ws)
    )
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


class WindowCrossAttention(nn.Module):
    """Windowed multi-head CROSS attention with a relative position bias:
    q from x (`qkv1`), k and v from the guide (`qkv2`), then `proj`."""

    def __init__(self, dim: int, window_size: int, num_heads: int):
        super().__init__()
        self.window_size, self.num_heads = window_size, num_heads
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros(((2 * window_size - 1) ** 2, num_heads)))
        self.qkv1 = Linear(dim, dim)
        self.qkv2 = Linear(dim, 2 * dim)
        self.proj = Linear(dim, dim)
        self.register_buffer(
            "relative_position_index",
            torch.from_numpy(_relative_position_index(window_size).reshape(
                -1).astype(np.int64)),
            persistent=False,
        )

    def forward(self, x, guided, mask: Optional[torch.Tensor] = None):
        B_, N, C = x.shape
        nh = self.num_heads
        head_dim = C // nh
        scale = head_dim ** -0.5
        q = self.qkv1(x).reshape(B_, N, nh, head_dim).permute(0, 2, 1, 3)
        kv = self.qkv2(guided).reshape(B_, N, 2, nh, head_dim).permute(
            2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        # (B_, nh, N, N)
        attn = precision.matmul(q * scale, k.transpose(-2, -1))
        rel_bias = self.relative_position_bias_table[
            self.relative_position_index].reshape(N, N, nh)
        attn = attn + rel_bias.permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nh, N, N)
                    + mask[None, :, None, :, :]).reshape(B_, nh, N, N)
        attn = torch.softmax(attn, dim=-1)
        return self.proj(precision.matmul(attn, v).transpose(1, 2).reshape(
            B_, N, C))


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (CompressAI's Mlp; dropout 0)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class SwinCrossBlock(nn.Module):
    """(Shifted-)window cross attention + MLP on (B, H, W, C) tokens.
    `norm1` is shared between x and the guide. A token grid of side
    `window_size` runs unshifted in one window; a smaller one would need
    a smaller bias table than the block's, and raises."""

    def __init__(self, dim: int, num_heads: int, window_size: int,
                 shift_size: int):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowCrossAttention(dim, window_size, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, 4 * dim)
        self._mask_key, self._mask_value = None, None

    def _mask(self, H, W, ws, shift, device):
        """The shift mask on the device, kept for the last geometry."""
        key = (H, W, ws, shift, str(device))
        if key != self._mask_key:
            self._mask_key = key
            self._mask_value = torch.from_numpy(
                _shift_attn_mask(H, W, ws, shift)).to(device)
        return self._mask_value

    def forward(self, x, guided):
        return remat.run(self._forward, x, guided)

    def _forward(self, x, guided):
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift_size
        if min(H, W) < ws:
            raise ValueError(f"a {H}x{W} token grid is smaller than the "
                             f"{ws}x{ws} window")
        if min(H, W) == ws:
            shift = 0
        shortcut = x
        xn, gn = self.norm1(x), self.norm1(guided)
        mask = None
        if shift > 0:
            xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))
            gn = torch.roll(gn, (-shift, -shift), dims=(1, 2))
            mask = self._mask(H, W, ws, shift, x.device)
        attn = self.attn(window_partition(xn, ws), window_partition(gn, ws),
                         mask)
        out = window_reverse(attn, ws, H, W)
        if shift > 0:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = shortcut + out
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    """k = s = patch conv, no padding (CompressAI's PatchEmbed `proj`)."""

    def __init__(self, in_channels: int, embed_dim: int, patch: int):
        super().__init__()
        self.proj = Conv2d(in_channels, embed_dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x)


class SpatialAligner(nn.Module):
    """Patch-embed both streams (2x2 patches, 96 channels), two Swin cross
    blocks of 3 heads on 4x4 windows (regular, then shifted by 2),
    un-patch (master.py:708-742)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.patch_embeding1 = _PatchEmbed(in_channels, 96, 2)
        self.patch_embeding2 = _PatchEmbed(in_channels, 96, 2)
        self.blocks = nn.ModuleList(
            SwinCrossBlock(96, 3, 4, 2 * i) for i in range(2))
        self.recovery = ConvTranspose2d(96, out_channels, 2, stride=2)

    def forward(self, x, guided):
        out = self.patch_embeding1(x).permute(0, 2, 3, 1)  # (B, H', W', C)
        g = self.patch_embeding2(guided).permute(0, 2, 3, 1)
        for block in self.blocks:
            out = block(out, g)
        # The reference's raw `view(B, C, H', W')` of its (B, L, C) tokens,
        # l-major and c-minor: a reinterpretation, not a transpose
        B, Hp, Wp, C = out.shape
        out = out.contiguous().view(B, C, Hp, Wp)
        return self.recovery(out)


# ---------------------------------------------------------------------------
# Guided compresser (master.py:1167-1464)
# ---------------------------------------------------------------------------


class GuidedEncoder(nn.Module):
    """mbt2018's analysis transform returning the three GDN maps
    (master.py:1167-1190, Encoder1)."""

    def __init__(self, channel: int, N: int, M: int, first_stride: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.g_a_conv1 = Conv(channel, N, stride=first_stride, dtype=dtype)
        self.g_a_gdn1 = GDN(N, dtype=dtype)
        self.g_a_conv2 = Conv(N, N, dtype=dtype)
        self.g_a_gdn2 = GDN(N, dtype=dtype)
        self.g_a_conv3 = Conv(N, N, dtype=dtype)
        self.g_a_gdn3 = GDN(N, dtype=dtype)
        self.g_a_conv4 = Conv(N, M, dtype=dtype)

    def forward(self, x):
        # the conv + GDN pairs are the blocks of `remat`, the last conv
        # joining the last pair (layers.GDNStack)
        g1 = remat.sequence((self.g_a_conv1, self.g_a_gdn1), x)
        g2 = remat.sequence((self.g_a_conv2, self.g_a_gdn2), g1)
        y, g3 = remat.run(self._last, g2)
        return y, g1, g2, g3

    def _last(self, x):
        g3 = self.g_a_gdn3(self.g_a_conv3(x))
        return self.g_a_conv4(g3), g3


class GuidedDecoder(nn.Module):
    """The synthesis transform returning the three IGDN maps
    (master.py:1194-1215, Decoder1)."""

    def __init__(self, channel: int, N: int, M: int, first_stride: int = 2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.g_s_conv1 = Deconv(M, N, dtype=dtype)
        self.g_s_gdn1 = GDN(N, inverse=True, dtype=dtype)
        self.g_s_conv2 = Deconv(N, N, dtype=dtype)
        self.g_s_gdn2 = GDN(N, inverse=True, dtype=dtype)
        self.g_s_conv3 = Deconv(N, N, dtype=dtype)
        self.g_s_gdn3 = GDN(N, inverse=True, dtype=dtype)
        self.g_s_conv4 = Deconv(N, channel, stride=first_stride, dtype=dtype)

    def forward(self, y_hat):
        g1 = remat.sequence((self.g_s_conv1, self.g_s_gdn1), y_hat)
        g2 = remat.sequence((self.g_s_conv2, self.g_s_gdn2), g1)
        x_hat, g3 = remat.run(self._last, g2)
        return x_hat, g1, g2, g3

    def _last(self, x):
        g3 = self.g_s_gdn3(self.g_s_conv3(x))
        return self.g_s_conv4(g3), g3


def _f32(maps, names):
    return {k: from_amp(v) for k, v in zip(names, maps)}


class GuidedCompresser(JointAutoregressiveHierarchicalPriors):
    """mbt2018 with hidden-feature taps. `channel` is the guide modality's
    channel count; `first_stride` is the first conv's stride (1 keeps a
    half-resolution guide on the master's grid). `analyze` is the
    inherited one, on the tapped encoder's y."""

    _transform_names = ("enc1", "dec1")

    def __init__(self, N: int, M: int, channel: int = 3,
                 first_stride: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        self.first_stride = int(first_stride)
        super().__init__(N, M, channel=channel, generator=generator,
                         dtype=dtype)

    @property
    def downsampling_factor(self) -> int:
        # the first conv at `first_stride`, 3 more stride-2 convs, hyper /4
        return 32 * self.first_stride

    def _make_g_a(self, channel, N, M, dt):
        return GuidedEncoder(channel, N, M, self.first_stride, dt)

    def _make_g_s(self, channel, N, M, dt):
        return GuidedDecoder(channel, N, M, self.first_stride, dt)

    def _encoder(self, x):
        return getattr(self, self._transform_names[0])(x)

    def _decoder(self, y_hat):
        return getattr(self, self._transform_names[1])(y_hat)

    def g_a(self, x):
        return from_amp(self._encoder(x)[0])

    def g_s(self, y_hat):
        return from_amp(self._decoder(y_hat)[0])

    def g_a_hidden(self, x):
        """y plus the encoder's hidden maps ga1..3, all f32."""
        y, *maps = self._encoder(x)
        return from_amp(y), _f32(maps, ("ga1", "ga2", "ga3"))

    def g_s_hidden(self, y_hat):
        """x_hat plus the decoder's hidden maps gs1..3 (what the master
        consumes), all f32."""
        x_hat, *maps = self._decoder(y_hat)
        return from_amp(x_hat), _f32(maps, ("gs1", "gs2", "gs3"))

    def forward(self, x, training: bool = True,
                generator: Optional[torch.Generator] = None):
        y, ga = self.g_a_hidden(x)
        out = self._entropy_forward(y, training, generator)
        x_hat, gs = self.g_s_hidden(out.pop("y_hat"))
        return {"x_hat": x_hat, "likelihoods": out["likelihoods"],
                "hidden": {**ga, **gs}}


# ---------------------------------------------------------------------------
# Master decoder / compresser (master.py:745-1161)
# ---------------------------------------------------------------------------


class MasterDecoder(nn.Module):
    """Three deconv + IGDN stages, each aligned against the guide's decoder
    map by a `SpatialAligner` and concatenated to it (so the next deconv
    takes 2N channels), then a stride-2 deconv to 128 feature channels.
    With a 1-channel master the guide is at twice its resolution, and each
    guide map first passes a stride-2 conv (`downsample1..3`)."""

    def __init__(self, N: int, M: int, master_chl: int):
        super().__init__()
        self.master_chl = master_chl
        if master_chl == 1:
            self.downsample1 = Conv(N, N)
            self.downsample2 = Conv(N, N)
            self.downsample3 = Conv(N, N)
        self.g_s_conv1 = Deconv(M, N)
        self.g_s_gdn1 = GDN(N, inverse=True)
        self.sp_aligner1 = SpatialAligner(N, N)
        self.g_s_conv2 = Deconv(2 * N, N)
        self.g_s_gdn2 = GDN(N, inverse=True)
        self.sp_aligner2 = SpatialAligner(N, N)
        self.g_s_conv3 = Deconv(2 * N, N)
        self.g_s_gdn3 = GDN(N, inverse=True)
        self.sp_aligner3 = SpatialAligner(N, N)
        self.g_s_conv4 = Deconv(2 * N, 128)

    def forward(self, y_hat, guide_hidden):
        out = y_hat
        for i in (1, 2, 3):
            g = guide_hidden[f"gs{i}"]
            if self.master_chl == 1:
                g = getattr(self, f"downsample{i}")(g)
            out = remat.sequence((getattr(self, f"g_s_conv{i}"),
                                  getattr(self, f"g_s_gdn{i}")), out)
            aligned = getattr(self, f"sp_aligner{i}")(out, g)
            out = torch.cat([aligned, out], dim=1)
        return self.g_s_conv4(out)


class MasterCompresser(JointAutoregressiveHierarchicalPriors):
    """The master-modality codec conditioned on the guide (master.py:
    839-1161). `channel` picks the roles: 1 codes a 1-channel master
    guided by a 3-channel guide at twice its resolution; 3 codes a
    3-channel master guided by a 1-channel guide at half its resolution.
    The pair's wire is f32: the transforms take no compute dtype."""

    _transform_names = ("g_a", "decoder")

    def __init__(self, N: int, M: int, channel: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(N, M, channel=channel, generator=generator,
                         dtype=dtype)
        roles = self._roles()
        self.fencoder1 = FeatureEncoder(roles["master_chl"],
                                        roles["master_stride"])
        self.fencoder2 = FeatureEncoder(roles["guided_chl"],
                                        roles["guided_stride"])
        self.ch_aligner = ChannelAligner()
        self.fdecoder = FeatureDecoder(128 + FEATURES, roles["master_chl"],
                                       roles["master_stride"])

    def _roles(self):
        if self.channel == 1:
            return dict(master_chl=1, guided_chl=3, master_stride=1,
                        guided_stride=2)
        return dict(master_chl=3, guided_chl=1, master_stride=2,
                    guided_stride=1)

    @property
    def downsampling_factor(self) -> int:
        # the feature encoder at master_stride, g_a's 4 stride-2 convs,
        # hyper /4
        return 64 * self._roles()["master_stride"]

    def _make_g_a(self, channel, N, M, dt):
        # its input: the master feature and the aligned guide feature
        return GDNStack(
            Conv(2 * FEATURES, N), GDN(N),
            Conv(N, N), GDN(N),
            Conv(N, N), GDN(N),
            Conv(N, M),
        )

    def _make_g_s(self, channel, N, M, dt):
        return MasterDecoder(N, M, self._roles()["master_chl"])

    def g_s(self, y_hat):
        raise NotImplementedError("the master needs the guide: use "
                                  "synthesize(y_hat, hidden, align)")

    def features(self, x, guided_hat):
        """-> (x_feature, guided_align, beta, gamma)."""
        x_feature = self.fencoder1(x)
        guided_align, beta, gamma = self.ch_aligner(
            x_feature, self.fencoder2(guided_hat))
        return x_feature, guided_align, beta, gamma

    def guided_align_from(self, guided_hat, beta, gamma):
        """The decoder's alignment from the transmitted beta/gamma
        (master.py:1059-1061)."""
        return gamma * self.fencoder2(guided_hat) + beta

    def analyze_features(self, x_feature, guided_align):
        y = self.g_a(torch.cat([x_feature, guided_align], dim=1))
        return y, self.h_a(y)

    def synthesize(self, y_hat, guide_hidden, guided_align):
        res = self.decoder(y_hat, guide_hidden)
        return self.fdecoder(torch.cat([res, guided_align], dim=1))

    def forward(self, x, guided_hat, guided_hidden, training: bool = True,
                generator: Optional[torch.Generator] = None):
        x_feature, guided_align, beta, gamma = self.features(x, guided_hat)
        y = self.g_a(torch.cat([x_feature, guided_align], dim=1))
        out = self._entropy_forward(y, training, generator)
        out["x_hat"] = self.synthesize(out.pop("y_hat"), guided_hidden,
                                       guided_align)
        return {**out, "beta": beta, "gamma": gamma}


# ---------------------------------------------------------------------------
# The codecs (master.py:953-1107, lmic_tpu/models/rgbt.py:474-790)
# ---------------------------------------------------------------------------


class GuidedCodec(JointARCodec):
    """The guide's AR codec, emitting the hidden maps as the reference's
    Guided_compresser does: `compress` -> ga*, `decompress` -> x_hat and
    gs*. Maps and reconstructions stay on the device as (B, C, H, W)
    float32 tensors: their consumer is the master's device work."""

    @torch.inference_mode()
    def compress(self, x, hidden: bool = True, reconstruct: bool = False):
        """x: (B, H, W, C) float in [0, 1] or uint8. With `reconstruct`,
        also the DECODER's output, "x_hat" and "hidden_dec", synthesized
        from the encoder's quantized latent: the wavefront loops make it
        equal bit for bit to what decode rebuilds from the streams, so the
        encoder side of the pair skips a decode. `hidden=False` skips the
        ga* maps' analysis pass."""
        self._check_updated()
        x = np.asarray(x)
        self._check_dims(x)
        set_wire_determinism()
        t0 = time.perf_counter()
        ys, z_sym = self._analyze(x)
        self._stat("enc_analysis_ms", t0)
        out = self._code_y_z(ys, z_sym, keep_y_hat=reconstruct)
        if reconstruct:
            t0 = time.perf_counter()
            out["x_hat"], out["hidden_dec"] = self._synthesize_hidden(
                out.pop("y_hat_latent"))
            self._stat("enc_reconstruct_ms", t0)
        if hidden:
            out["hidden"] = self.module.g_a_hidden(self._pixels(x))[1]
        return out

    def _synthesize_hidden(self, y_hat):
        x_hat, maps = self.module.g_s_hidden(
            y_hat.contiguous(memory_format=torch.channels_last))
        return torch.clamp(x_hat, 0.0, 1.0), maps

    @torch.inference_mode()
    def decompress(self, strings, shape):
        """-> {"x_hat": (B, C, H, W) in [0, 1], "hidden": gs1..3}, on the
        device."""
        self._check_updated()
        set_wire_determinism()
        y_hat = self._decode_y_hat(strings, shape)
        t0 = time.perf_counter()
        x_hat, maps = self._synthesize_hidden(y_hat)
        self._stat("dec_synthesis_ms", t0)
        return {"x_hat": x_hat, "hidden": maps}


class MasterCodec(JointARCodec):
    """The master's AR codec. `compress` takes the guide's reconstruction;
    `decompress` re-derives the guide alignment from the transmitted
    beta/gamma and the guide's reconstruction, and synthesizes with the
    guide's decoder maps. Wavefront symbol order, or raster."""

    # the RGB-T container stores no padding geometry
    _dims_hint = ("crop or resize first (the RGBT container cannot record "
                  "padding)")

    def expected_guide_hw(self, H, W):
        """The guide's (H, W) for a master of (H, W): both feature encoders
        must land on the same grid (channel 1: the guide at 2x; channel 3:
        at half)."""
        roles = self.module._roles()
        return (H * roles["guided_stride"] // roles["master_stride"],
                W * roles["guided_stride"] // roles["master_stride"])

    def check_geometry(self, H, W, guide_hw=None,
                       guide_what="guide reconstruction"):
        """Validate a master geometry (and a guide's) without running
        anything; raises ValueError on a mismatch and returns the expected
        guide (H, W)."""
        factor = self.module.downsampling_factor
        if H % factor or W % factor:
            raise ValueError(
                f"master dims ({H}, {W}) must be multiples of {factor} at "
                f"channel={self.module.channel}; {self._dims_hint}"
            )
        gH, gW = self.expected_guide_hw(H, W)
        if guide_hw is not None and tuple(guide_hw) != (gH, gW):
            raise ValueError(
                f"{guide_what} must be {gH}x{gW} for a {H}x{W} master at "
                f"channel={self.module.channel}; got "
                f"{guide_hw[0]}x{guide_hw[1]}"
            )
        return gH, gW

    def _guide(self, guided_hat) -> torch.Tensor:
        """The guide's reconstruction as (B, C, H, W) float32 on the device:
        a tensor (the guided codec's x_hat) as is, (B, H, W, C) numpy
        (float in [0, 1] or uint8) as pixels."""
        if isinstance(guided_hat, torch.Tensor):
            return guided_hat.to(self.device, torch.float32)
        return self._pixels(np.asarray(guided_hat))

    @torch.inference_mode()
    def compress(self, x, guided_hat, order: str = "wavefront"):
        """x: (B, H, W, C) float in [0, 1] or uint8. The feature chain stays
        on the device, one image at a time; the y latents go to the
        wavefront loop (the raster one with `order="raster"`, the
        reference master container's order, codec_rgbt.py:377-382) and
        only the z symbols, beta and gamma ((B, 64, 1, 1) numpy) come to
        the host."""
        self._check_updated()
        x = np.asarray(x)
        g = self._guide(guided_hat)
        self.check_geometry(int(x.shape[1]), int(x.shape[2]),
                            tuple(g.shape[2:]))
        set_wire_determinism()
        t0 = time.perf_counter()
        z_med = self._medians(self.eb_state)
        ys, z_syms, betas, gammas = [], [], [], []
        for i in range(x.shape[0]):
            x_feature, align, beta, gamma = self.module.features(
                self._pixels(x[i:i + 1]), g[i:i + 1])
            y, z = self.module.analyze_features(x_feature, align)
            ys.append(y)
            z_syms.append(_symbols_to_host(torch.round(z - z_med)))
            betas.append(beta)
            gammas.append(gamma)
        self._stat("enc_analysis_ms", t0)
        out = self._code_y_z(ys, np.concatenate(z_syms), order=order)
        out["beta"] = torch.cat(betas).cpu().numpy()
        out["gamma"] = torch.cat(gammas).cpu().numpy()
        return out

    @torch.inference_mode()
    def decompress(self, out_net, out_net_guided, u8: bool = False,
                   order: str = "wavefront"):
        """out_net: {"strings", "shape", "beta", "gamma"}; out_net_guided:
        the guided codec's {"x_hat", "hidden"}; `order`: the streams'
        symbol order. -> {"x_hat": (B, H, W, C) numpy in [0, 1], uint8
        levels when `u8`}."""
        self._check_updated()
        set_wire_determinism()
        t0 = time.perf_counter()
        B = len(out_net["strings"][0])

        def side(v):
            return torch.as_tensor(np.asarray(v, np.float32)).reshape(
                B, -1, 1, 1).to(self.device)

        guided_align = self.module.guided_align_from(
            self._guide(out_net_guided["x_hat"]), side(out_net["beta"]),
            side(out_net["gamma"]))
        self._stat("dec_align_ms", t0)
        y_hat = self._decode_y_hat(out_net["strings"], out_net["shape"],
                                   order)
        t0 = time.perf_counter()
        x_hat = self.module.synthesize(
            y_hat.contiguous(memory_format=torch.channels_last),
            out_net_guided["hidden"], guided_align)
        out = _image_out(x_hat, u8)
        self._stat("dec_synthesis_ms", t0)
        return out
