"""ScaleSpaceFlow (ssf2020), the video codec, and its GOP coding wrapper.

Counterpart of lmic_tpu/models/video.py (reference
compressai/models/video/google.py:55-508). Three hyperprior sub-codecs
(the I-frame, the motion and the residual) around 5x5 stride-2 conv
stacks; an inter frame warps the previous reconstruction through a
Gaussian scale-space volume along a decoded (flow, scale) field
(ops/video.py), then adds a decoded residual. Frames depend on each other
through that reconstruction, so a group of pictures (GOP) is one chain.

Module and attribute names are CompressAI's (`img_encoder.0..6`,
`motion_hyperprior.hyper_decoder_scale.deconv1`, ...), so `state_dict()`
keys are the reference's. The module is NCHW: `forward(frames)` takes
(B, T, 3, H, W). The codec takes (B, T, H, W, 3) numpy frames, uint8 or
float in [0, 1], as lmic_tpu's does.

Wire determinism (models/codec.py): every sequence runs its GOP chain at
batch size 1 under `set_wire_determinism()`, and `_HyperpriorState.
params_from_zsym` is the one place the entropy parameters are derived from
z symbols, on the encode side and on the decode side alike. The encoder's
in-loop latents are `round(y - means) + means` and the decoder's `symbols +
means`: the same f32 values, so both sides warp the same reference.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lmic_tpu_torch.entropy import coder as rans
from lmic_tpu_torch.entropy.entropy_models import (
    EBState,
    EntropyBottleneck,
    GaussianConditional,
    GCState,
    eb_update,
    get_scale_table,
)
from lmic_tpu_torch.layers import Conv, Deconv, qrelu
from lmic_tpu_torch.models.codec import (
    CompressionCodec,
    _cl,
    _FanOut,
    _Fetch,
    _narrowest_int,
    _only,
    _to_device,
)
from lmic_tpu_torch.ops.math import ste_round
from lmic_tpu_torch.ops.video import scale_space_warp
from lmic_tpu_torch.utils.determinism import set_wire_determinism


class Encoder(nn.Sequential):
    """4x conv5 s2, ReLU between (reference video/google.py:75-88)."""

    def __init__(self, in_planes: int, mid_planes: int = 128,
                 out_planes: int = 192):
        super().__init__(
            Conv(in_planes, mid_planes), nn.ReLU(),
            Conv(mid_planes, mid_planes), nn.ReLU(),
            Conv(mid_planes, mid_planes), nn.ReLU(),
            Conv(mid_planes, out_planes),
        )


class Decoder(nn.Sequential):
    """4x deconv5 s2, ReLU between (reference video/google.py:90-103)."""

    def __init__(self, out_planes: int, in_planes: int = 192,
                 mid_planes: int = 128):
        super().__init__(
            Deconv(in_planes, mid_planes), nn.ReLU(),
            Deconv(mid_planes, mid_planes), nn.ReLU(),
            Deconv(mid_planes, mid_planes), nn.ReLU(),
            Deconv(mid_planes, out_planes),
        )


class HyperEncoder(nn.Sequential):
    def __init__(self, in_planes: int = 192, mid_planes: int = 192,
                 out_planes: int = 192):
        super().__init__(
            Conv(in_planes, mid_planes), nn.ReLU(),
            Conv(mid_planes, mid_planes), nn.ReLU(),
            Conv(mid_planes, out_planes),
        )


class HyperDecoder(nn.Sequential):
    def __init__(self, in_planes: int = 192, mid_planes: int = 192,
                 out_planes: int = 192):
        super().__init__(
            Deconv(in_planes, mid_planes), nn.ReLU(),
            Deconv(mid_planes, mid_planes), nn.ReLU(),
            Deconv(mid_planes, out_planes),
        )


class HyperDecoderWithQReLU(nn.Module):
    """The scale branch, QReLU after each deconv; named fields, not
    Sequential indices (reference video/google.py:128-150)."""

    def __init__(self, in_planes: int = 192, mid_planes: int = 192,
                 out_planes: int = 192):
        super().__init__()
        self.deconv1 = Deconv(in_planes, mid_planes)
        self.deconv2 = Deconv(mid_planes, mid_planes)
        self.deconv3 = Deconv(mid_planes, out_planes)

    def forward(self, x):
        x = qrelu(self.deconv1(x))
        x = qrelu(self.deconv2(x))
        return qrelu(self.deconv3(x))


class Hyperprior(nn.Module):
    """One sub-codec's hyperprior: the bottleneck on z, a Gaussian
    conditional on y with mean and scale hyper decoders, STE-rounded y_hat
    (reference video/google.py:152-196)."""

    def __init__(self, planes: int = 192, mid_planes: int = 192,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.entropy_bottleneck = EntropyBottleneck(mid_planes,
                                                    generator=generator)
        self.hyper_encoder = HyperEncoder(planes, mid_planes, planes)
        self.hyper_decoder_mean = HyperDecoder(planes, mid_planes, planes)
        self.hyper_decoder_scale = HyperDecoderWithQReLU(planes, mid_planes,
                                                         planes)
        self.gaussian_conditional = GaussianConditional()

    def params(self, z_hat):
        """z_hat -> (scales, means)."""
        return self.hyper_decoder_scale(z_hat), self.hyper_decoder_mean(z_hat)

    def forward(self, y, training: bool = True,
                generator: Optional[torch.Generator] = None):
        z = self.hyper_encoder(y)
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator)
        scales, means = self.params(z_hat)
        _, y_likelihoods = self.gaussian_conditional(
            y, scales, means, training=training, generator=generator)
        y_hat = ste_round(y - means) + means
        return y_hat, {"y": y_likelihoods, "z": z_likelihoods}

    def aux_loss(self):
        return self.entropy_bottleneck.aux_loss()


class ScaleSpaceFlow(nn.Module):
    """ssf2020 (reference video/google.py:55-235)."""

    # encoder /16, hyper encoder /8: z only round-trips when H and W
    # divide 128
    downsampling_factor = 128

    def __init__(self, num_levels: int = 5, sigma0: float = 1.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_levels = int(num_levels)
        self.sigma0 = float(sigma0)
        self.img_encoder = Encoder(3)
        self.img_decoder = Decoder(3)
        self.img_hyperprior = Hyperprior(generator=generator)
        self.res_encoder = Encoder(3)
        self.res_decoder = Decoder(3, in_planes=384)
        self.res_hyperprior = Hyperprior(generator=generator)
        self.motion_encoder = Encoder(2 * 3)
        self.motion_decoder = Decoder(2 + 1)  # the flow (dx, dy), the scale
        self.motion_hyperprior = Hyperprior(generator=generator)

    def forward_prediction(self, x_ref, motion_info):
        return scale_space_warp(x_ref, motion_info[:, :2],
                                motion_info[:, 2:3], self.sigma0,
                                self.num_levels)

    def forward_keyframe(self, x, training: bool = True,
                         generator: Optional[torch.Generator] = None):
        y_hat, likelihoods = self.img_hyperprior(
            self.img_encoder(x), training=training, generator=generator)
        return self.img_decoder(y_hat), {"keyframe": likelihoods}

    def forward_inter(self, x_cur, x_ref, training: bool = True,
                      generator: Optional[torch.Generator] = None):
        y_motion_hat, motion_likelihoods = self.motion_hyperprior(
            self.motion_encode(x_cur, x_ref), training=training,
            generator=generator)
        x_pred = self.motion_decode_predict(y_motion_hat, x_ref)
        y_res_hat, res_likelihoods = self.res_hyperprior(
            self.res_encoder(x_cur - x_pred), training=training,
            generator=generator)
        x_rec = x_pred + self.res_decode(y_res_hat, y_motion_hat)
        return x_rec, {"motion": motion_likelihoods,
                       "residual": res_likelihoods}

    def forward(self, frames, training: bool = True,
                generator: Optional[torch.Generator] = None):
        """frames: (B, T, 3, H, W). Per-frame reconstructions (B, T, 3, H,
        W) and likelihood dicts; no gradient flows through a reference
        frame (reference :224)."""
        x_hat, lk = self.forward_keyframe(frames[:, 0], training, generator)
        recs, likelihoods = [x_hat], [lk]
        x_ref = x_hat.detach()
        for i in range(1, frames.shape[1]):
            x_ref, lk = self.forward_inter(frames[:, i], x_ref, training,
                                           generator)
            recs.append(x_ref)
            likelihoods.append(lk)
            x_ref = x_ref.detach()
        return {"x_hat": torch.stack(recs, dim=1), "likelihoods": likelihoods}

    def aux_loss(self):
        return (self.img_hyperprior.aux_loss()
                + self.res_hyperprior.aux_loss()
                + self.motion_hyperprior.aux_loss())

    # -- the device halves of the coding path --
    def img_encode(self, x):
        return self.img_encoder(x)

    def img_decode(self, y_hat):
        return self.img_decoder(y_hat)

    def motion_encode(self, x_cur, x_ref):
        return self.motion_encoder(torch.cat([x_cur, x_ref], dim=1))

    def motion_decode_predict(self, y_motion_hat, x_ref):
        # the warp writes NCHW: back to the layout every conv reads
        return self.forward_prediction(
            x_ref, self.motion_decoder(y_motion_hat)).contiguous(
                memory_format=torch.channels_last)

    def res_encode(self, x_res):
        return self.res_encoder(x_res)

    def res_decode(self, y_res_hat, y_motion_hat):
        return self.res_decoder(torch.cat([y_res_hat, y_motion_hat], dim=1))

    def hp_encode_z(self, y, which: str):
        return getattr(self, f"{which}_hyperprior").hyper_encoder(y)

    def hp_params(self, z_hat, which: str):
        return getattr(self, f"{which}_hyperprior").params(z_hat)


class _HyperpriorState:
    """The coding state of one Hyperprior sub-codec (its bottleneck's and
    Gaussian conditional's tables) and its device halves.
    Immutable: new tables make a new state."""

    gc = GaussianConditional()

    def __init__(self, codec: "ScaleSpaceFlowCodec", which: str,
                 eb_state: EBState, gc_state: GCState):
        self.codec, self.which = codec, which
        self.eb_state, self.gc_state = eb_state, gc_state
        self._medians = codec._medians(eb_state)
        self._table = torch.from_numpy(gc_state.scale_table).to(codec.device)

    def params_from_zsym(self, z_sym: torch.Tensor):
        """Entropy parameters from z symbols (1, C, h, w) on the device:
        (uint8 scale indexes, means) (`_params`)."""
        return _params(self.codec.module, self.which, self._medians,
                       self._table, z_sym)

    def device_part(self, y: torch.Tensor):
        """The device half of compress, with no host sync (`_device_part`):
        the in-loop y_hat and the float symbols and indexes (z_sym, idx,
        y_sym)."""
        return _device_part(self.codec.module, self.which, self._medians,
                            self._table, y)

    def code_part(self, z_sym: np.ndarray, idx: np.ndarray,
                  y_sym: np.ndarray):
        """Host rANS of one (z, y) stream pair of fetched symbols, coded
        channel-major: {"strings": [y_strings, z_strings], "shape"}."""
        B, Cz, h, w = z_sym.shape
        z_strings = rans.encode_batch(
            z_sym.reshape(B, -1),
            np.repeat(np.arange(Cz, dtype=np.int32), h * w),
            self.eb_state.table)
        y_strings = rans.encode_batch(y_sym.reshape(B, -1),
                                      idx.reshape(B, -1), self.gc_state.table)
        return {"strings": [y_strings, z_strings], "shape": (h, w)}

    def decode_z(self, z_strings, shape) -> np.ndarray:
        """Host rANS of the (independent) z streams: int32 (B, C, h, w)."""
        return self.eb_state.decode_symbols(z_strings, tuple(shape))

    def decode_y(self, y_strings, idx: np.ndarray) -> np.ndarray:
        return rans.decode_batch(y_strings, idx.reshape(idx.shape[0], -1),
                                 self.gc_state.table).reshape(idx.shape)

    def compress(self, y: torch.Tensor):
        """Per-frame compress: (y_hat on the device, {"strings",
        "shape"}), one fetch per part."""
        y_hat, (z_sym, idx, y_sym) = self.device_part(y)
        out = self.code_part(*(_host_int32(t) for t in (z_sym, idx, y_sym)))
        return y_hat, out

    def decompress(self, strings, shape) -> torch.Tensor:
        """Per-frame decompress: y_hat on the device."""
        y_strings, z_strings = strings
        z_sym = self.decode_z(z_strings, shape)
        idx, means = self.params_from_zsym(self.codec._upload(z_sym))
        y_sym = self.decode_y(y_strings, _host_int32(idx))
        return _cl(self.codec._upload(y_sym) + means)


def _params(module, which: str, z_medians, table, z_sym):
    """Entropy parameters of sub-codec `which` from z symbols (1, C, h, w)
    on the device: (uint8 scale indexes, means). The one place they are
    derived, on both sides of the wire (lmic_tpu's `_params_from_zsym`)."""
    z_hat = _cl(z_sym.float() + z_medians)
    scales, means = module.hp_params(z_hat, which)
    indexes = _HyperpriorState.gc.build_indexes(table, scales)
    return indexes.to(torch.uint8), means


def _device_part(module, which: str, z_medians, table, y):
    """Sub-codec `which`'s device half of compress, with no host sync: the
    in-loop y_hat and the float symbols and indexes (z_sym, idx, y_sym)."""
    z = module.hp_encode_z(y, which)
    z_sym = torch.round(z - z_medians)
    idx, means = _params(module, which, z_medians, table, z_sym)
    y_sym = torch.round(y - means)
    return _cl(y_sym + means), (z_sym, idx, y_sym)


# Hyperprior's planes and mid_planes: the channels of every sub-codec's y
# and z
PLANES = 192


def _labels(T: int):
    """The sub-codecs of a T-frame GOP's parts, in coding order."""
    return ["img"] + ["motion", "res"] * (T - 1)


class _GopGraph(nn.Module):
    """A device function of the GOP chain: a view of the module holding
    the submodules `paths` (all of it when none is given) and each
    sub-codec's z medians and scale table, the tensors of its state."""

    def __init__(self, codec: "ScaleSpaceFlowCodec", *paths: str):
        super().__init__()
        self.module = _only(codec.module, *paths) if paths else codec.module
        for which, st in codec.hp_states.items():
            self.register_buffer(f"{which}_z_medians", st._medians)
            self.register_buffer(f"{which}_scale_table", st._table)

    def consts(self, which: str):
        return (getattr(self, f"{which}_z_medians"),
                getattr(self, f"{which}_scale_table"))


class _GopEncode(_GopGraph):
    """One sequence's GOP encode (lmic_tpu's `_compress_chunk_dispatch`
    and `_pack_gop`): frames (1, T, 3, H, W) float -> one uint8 buffer, per
    part (the keyframe's, then each inter frame's motion and residual)
    its int32 z symbols, uint8 scale indexes and int32 y symbols, each
    channel-major."""

    def chain(self, x):
        """The GOP's device chain: [(sub-codec, (z_sym, idx, y_sym))] in
        coding order, and the in-loop reconstructions."""
        m = self.module

        def part(which, y):
            return _device_part(m, which, *self.consts(which), y)

        y_hat, p = part("img", m.img_encode(x[:, 0]))
        x_ref = m.img_decode(y_hat)
        parts, recs = [("img", p)], [x_ref]
        for i in range(1, x.shape[1]):
            x_cur = x[:, i]
            y_motion_hat, pm = part("motion", m.motion_encode(x_cur, x_ref))
            x_pred = m.motion_decode_predict(y_motion_hat, x_ref)
            y_res_hat, pr = part("res", m.res_encode(x_cur - x_pred))
            x_ref = x_pred + m.res_decode(y_res_hat, y_motion_hat)
            parts += [("motion", pm), ("res", pr)]
            recs.append(x_ref)
        return parts, recs

    def forward(self, x):
        pieces = []
        for _, (z_sym, idx, y_sym) in self.chain(x)[0]:
            pieces += [z_sym.to(torch.int32).reshape(-1).view(torch.uint8),
                       idx.reshape(-1),
                       y_sym.to(torch.int32).reshape(-1).view(torch.uint8)]
        return torch.cat(pieces)


class _GopParams(_GopGraph):
    """The decoder's entropy parameters of a GOP's parts: integer z
    symbols (K, C, h, w) -> (uint8 scale indexes (K, C, H, W)
    channel-major, means (K, C, H, W)), each part through its sub-codec's
    `_params` at batch 1."""

    def __init__(self, codec):
        super().__init__(codec, *(
            f"{w}_hyperprior.hyper_decoder_{k}"
            for w in codec.SUB_CODECS for k in ("mean", "scale")))

    def forward(self, z_sym):
        out = [_params(self.module, which, *self.consts(which),
                       z_sym[k:k + 1])
               for k, which in enumerate(_labels((z_sym.shape[0] + 1) // 2))]
        return (torch.cat([idx for idx, _ in out]).contiguous(),
                torch.cat([means for _, means in out]))


class _GopFrames(_GopGraph):
    """The decoder's frame chain: integer y symbols (K, C, H, W) and the
    means -> the frames (1, T, 3, H, W) as the chain computes them."""

    def __init__(self, codec):
        super().__init__(codec, "img_decoder", "motion_decoder",
                         "res_decoder")

    def forward(self, y_sym, means):
        m = self.module
        y_hats = [_cl(y_sym[k:k + 1].float() + means[k:k + 1])
                  for k in range(y_sym.shape[0])]
        x_ref = m.img_decode(y_hats[0])
        frames = [x_ref]
        for k in range(1, len(y_hats), 2):
            y_motion_hat, y_res_hat = y_hats[k], y_hats[k + 1]
            x_pred = m.motion_decode_predict(y_motion_hat, x_ref)
            x_ref = x_pred + m.res_decode(y_res_hat, y_motion_hat)
            frames.append(x_ref)
        return torch.stack(frames, dim=1)


class _IngestU8(nn.Module):
    """(B, T, H, W, 3) pixels -> (B, T, 3, H, W) float32 frames; uint8 maps
    to [0, 1] as u8 / 255."""

    def forward(self, frames):
        t = frames.float() / 255.0 if frames.dtype == torch.uint8 \
            else frames.float()
        return t.permute(0, 1, 4, 2, 3)


class _EgressU8(nn.Module):
    """(B, T, 3, H, W) frames -> uint8 levels round(clip(x, 0, 1) * 255),
    (B, T, H, W, 3)."""

    def forward(self, x):
        x = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
        return x.permute(0, 1, 3, 4, 2).contiguous()


def _host_int32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.int32).cpu().numpy()


def _slice_strings(s, lo, hi):
    """Per-frame strings are [y_strings, z_strings] lists (keyframe) or
    {"motion"/"residual": [...]} dicts (inter); slice the batch items."""
    if isinstance(s, dict):
        return {k: _slice_strings(v, lo, hi) for k, v in s.items()}
    return [part[lo:hi] for part in s]


def _merge_strings(parts):
    """The inverse of `_slice_strings`: concatenate per-sequence items."""
    if isinstance(parts[0], dict):
        return {k: _merge_strings([p[k] for p in parts]) for k in parts[0]}
    return [sum((p[i] for p in parts), []) for i in range(len(parts[0]))]


def _gop_parts(strings, shapes):
    """A GOP's wire strings and shapes -> [(sub-codec, strings, shape)]:
    the keyframe's, then each inter frame's motion and residual."""
    if len(strings) != len(shapes) or not strings:
        raise ValueError(f"{len(strings)} frames of strings, "
                         f"{len(shapes)} of shapes")
    if isinstance(strings[0], dict):
        raise ValueError("the first frame of a GOP must be a keyframe")
    parts = [("img", strings[0], shapes[0])]
    for s, shp in zip(strings[1:], shapes[1:]):
        if not isinstance(s, dict):
            raise ValueError("a GOP has one keyframe, its first frame")
        parts += [("motion", s["motion"], shp["motion"]),
                  ("res", s["residual"], shp["residual"])]
    n = len(parts[0][1][0])
    for _, s, _ in parts:
        if len(s) != 2 or not len(s[0]) == len(s[1]) == n:
            raise ValueError("a sub-codec's strings are [y, z] groups of "
                             "one string per sequence")
    return parts


class ScaleSpaceFlowCodec(_FanOut, CompressionCodec):
    """The GOP coding wrapper: the frame chain on the device, three
    sub-codec states, host rANS.

    `compress(frames) -> (frame_strings, shape_infos)`: per frame the
    keyframe's [y_strings, z_strings], or an inter frame's {"motion":
    [...], "residual": [...]}, and the z shapes alike;
    `decompress(strings, shapes, u8=False)` -> (B, T, H, W, 3) numpy, f32
    as the chain computed it (unclipped) or uint8 levels.

    The whole-GOP paths (`_compress_chunk`, `_decompress_chunk`) cross the
    host-device link once for the GOP's symbols and indexes on encode;
    on decode once up for the z symbols, once down for all scale indexes,
    once up for all y symbols and once down for the stacked frames. Their
    device halves are the modules `_ingest_u8`, `_gop_encode`,
    `_gop_params`, `_gop_frames` and `_egress_u8` (lmic_tpu's names where
    it has them), built with the tables and exported by utils/aot.py; the
    host halves run unchanged on top of a bundle's. `compress_async` and
    `decompress_async` split each path at its last copy to the host. The
    per-frame paths (`_compress_chunk_sync`, `_decompress_chunk_sync`,
    over `encode_keyframe` ... `decode_inter`) compute the same bytes.

    A multi-sequence batch runs one B = 1 chain a sequence; with
    `fanout(devices)` (`parallel.shard_codec`) the sequences go
    round-robin over the devices, one worker thread a device
    (`_chunk_map`), each chain whole on its device: the bytes and frames
    of one device.
    """

    SUB_CODECS = ("img", "motion", "res")
    _FACTOR = ScaleSpaceFlow.downsampling_factor

    def __init__(self, module: ScaleSpaceFlow, device=None):
        super().__init__(module, device)
        self.hp_states: Dict[str, _HyperpriorState] = {}

    def update(self, force: bool = False):
        if self.hp_states and not force:
            return False
        gc_state = GaussianConditional().update(get_scale_table())
        self.install_tables({
            which: (eb_update(getattr(
                self.module, f"{which}_hyperprior").entropy_bottleneck),
                gc_state)
            for which in self.SUB_CODECS})
        return True

    def install_tables(self, tables: Dict[str, Tuple[EBState, GCState]]):
        """Adopt the three sub-codecs' coding tables, {which: (eb, gc)}."""
        if set(tables) != set(self.SUB_CODECS):
            raise ValueError(f"tables for {sorted(tables)}, want "
                             f"{sorted(self.SUB_CODECS)}")
        self.hp_states = {which: _HyperpriorState(self, which, eb, gc)
                          for which, (eb, gc) in tables.items()}
        self._ingest_u8 = _IngestU8()
        self._gop_encode = _GopEncode(self)
        self._gop_params = _GopParams(self)
        self._gop_frames = _GopFrames(self)
        self._egress_u8 = _EgressU8()

    def _check_updated(self):
        if not self.hp_states:
            raise RuntimeError("Uninitialized CDFs. Run update() first")

    def _on(self, device):
        view = super()._on(device)
        if view is not self:  # the GOP graphs hold the tables' tensors
            view.install_tables({w: (st.eb_state, st.gc_state)
                                 for w, st in self.hp_states.items()})
        return view

    # lmic_tpu's name for the per-sequence fan-out
    _chunk_map = _FanOut._fanout_map

    def _check_frame_dims(self, frames: np.ndarray):
        if frames.ndim != 5 or frames.shape[-1] != 3:
            raise ValueError(f"frames are (B, T, H, W, 3), got "
                             f"{frames.shape}")
        H, W = frames.shape[2:4]
        if H % self._FACTOR or W % self._FACTOR:
            raise ValueError(
                f"frame spatial dims ({H}, {W}) must be multiples of "
                f"{self._FACTOR}; pad first (CLIs use centered padding)")

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _frames(self, frames: np.ndarray) -> torch.Tensor:
        """(B, T, H, W, 3) numpy -> (B, T, 3, H, W) float32 on the device,
        each frame channels_last; uint8 crosses as uint8 and maps to
        [0, 1] as u8 / 255 on the device."""
        return self._ingest_u8(_to_device(frames, self.device))

    def _pixels_out(self, x: torch.Tensor, u8: bool) -> torch.Tensor:
        """(B, T, 3, H, W) -> (B, T, H, W, 3) on the device; uint8 levels
        `round(clip(x, 0, 1) * 255)` when `u8`."""
        if u8:
            return self._egress_u8(x)
        return x.permute(0, 1, 3, 4, 2).contiguous()

    # -- the per-frame chain: device tensors in and out --
    @torch.inference_mode()
    def encode_keyframe(self, x: torch.Tensor):
        y_hat, out = self.hp_states["img"].compress(self.module.img_encode(x))
        return self.module.img_decode(y_hat), out

    @torch.inference_mode()
    def decode_keyframe(self, strings, shape) -> torch.Tensor:
        return self.module.img_decode(
            self.hp_states["img"].decompress(strings, shape))

    @torch.inference_mode()
    def encode_inter(self, x_cur: torch.Tensor, x_ref: torch.Tensor):
        m = self.module
        y_motion_hat, out_motion = self.hp_states["motion"].compress(
            m.motion_encode(x_cur, x_ref))
        x_pred = m.motion_decode_predict(y_motion_hat, x_ref)
        y_res_hat, out_res = self.hp_states["res"].compress(
            m.res_encode(x_cur - x_pred))
        x_rec = x_pred + m.res_decode(y_res_hat, y_motion_hat)
        return x_rec, {
            "strings": {"motion": out_motion["strings"],
                        "residual": out_res["strings"]},
            "shape": {"motion": out_motion["shape"],
                      "residual": out_res["shape"]},
        }

    @torch.inference_mode()
    def decode_inter(self, x_ref: torch.Tensor, strings, shapes):
        m = self.module
        y_motion_hat = self.hp_states["motion"].decompress(
            strings["motion"], shapes["motion"])
        x_pred = m.motion_decode_predict(y_motion_hat, x_ref)
        y_res_hat = self.hp_states["res"].decompress(
            strings["residual"], shapes["residual"])
        return x_pred + m.res_decode(y_res_hat, y_motion_hat)

    # -- compress --
    @torch.inference_mode()
    def compress(self, frames):
        """frames: (B, T, H, W, 3), uint8 or float in [0, 1]; H and W
        multiples of 128. A multi-sequence batch runs one B = 1 chain per
        sequence, so the wire does not depend on the grouping."""
        self._check_updated()
        frames = np.asarray(frames)
        self._check_frame_dims(frames)
        set_wire_determinism()
        if frames.shape[0] == 1:
            return self._compress_chunk(frames)
        parts = self._chunk_map(
            frames.shape[0],
            lambda i, codec: codec._compress_chunk(frames[i:i + 1]))
        return ([_merge_strings([p[0][t] for p in parts])
                 for t in range(frames.shape[1])], parts[0][1])

    def compress_async(self, frames):
        """Dispatch one sequence's whole GOP chain and start its packed
        buffer's copy to the host; the finalizer waits for that copy and
        runs the host rANS, so a caller codes this GOP while the device
        runs the next. A multi-sequence batch is coded here, per
        sequence, and the finalizer returns it."""
        self._check_updated()
        frames = np.asarray(frames)
        self._check_frame_dims(frames)
        if frames.shape[0] > 1:
            out = self.compress(frames)
            return lambda: out
        t0 = time.perf_counter()
        fetch = self._compress_chunk_dispatch(frames)
        self._stat("enc_dispatch_ms", t0)
        return lambda: self._compress_chunk_finish(frames, fetch)

    @torch.inference_mode()
    def _encode_gop(self, x: torch.Tensor):
        """The GOP's device chain, no host sync: [(sub-codec, (z_sym, idx,
        y_sym))] in coding order, and the in-loop reconstructions."""
        return self._gop_encode.chain(x)

    @staticmethod
    def _frame_strings(outs, T):
        """Coded parts in GOP order -> (frame_strings, shape_infos)."""
        strings, shapes = [outs[0]["strings"]], [outs[0]["shape"]]
        for k in range(1, 2 * T - 1, 2):
            om, orr = outs[k], outs[k + 1]
            strings.append({"motion": om["strings"],
                            "residual": orr["strings"]})
            shapes.append({"motion": om["shape"], "residual": orr["shape"]})
        return strings, shapes

    def _compress_chunk(self, frames: np.ndarray):
        """Whole-GOP encode of one sequence with one device -> host fetch:
        every part's int32 z and y symbols and uint8 indexes, packed."""
        t0 = time.perf_counter()
        fetch = self._compress_chunk_dispatch(frames)
        self._sync()
        self._stat("enc_device_ms", t0)
        return self._compress_chunk_finish(frames, fetch)

    @torch.inference_mode()
    def _compress_chunk_dispatch(self, frames: np.ndarray):
        """Enqueue the GOP's device chain and its packed buffer's copy to
        the host, with no host sync."""
        set_wire_determinism()
        return _Fetch(self._gop_encode(self._frames(frames)))

    def _compress_chunk_finish(self, frames: np.ndarray, fetch):
        """Wait for the packed buffer and host-code every part."""
        t0 = time.perf_counter()
        buf = fetch.result()
        t0 = self._stat("enc_fetch_ms", t0)
        _, T, H, W, _ = frames.shape
        zshape = (1, PLANES, H // self._FACTOR, W // self._FACTOR)
        yshape = (1, PLANES, H // 16, W // 16)
        outs, off = [], 0
        for which in _labels(T):
            arrays = []
            for shape, dt in ((zshape, np.int32), (yshape, np.uint8),
                              (yshape, np.int32)):
                n = int(np.prod(shape)) * np.dtype(dt).itemsize
                arrays.append(buf[off:off + n].view(dt).reshape(shape))
                off += n
            outs.append(self.hp_states[which].code_part(*arrays))
        if off != buf.size:
            raise ValueError("packed GOP layout mismatch")
        self._stat("enc_rans_ms", t0)
        return self._frame_strings(outs, T)

    @torch.inference_mode()
    def _compress_chunk_sync(self, frames: np.ndarray):
        """The per-frame chain (lmic_tpu's reference-shaped loop): the
        same bytes as `_compress_chunk`."""
        x = self._frames(frames)
        x_ref, out = self.encode_keyframe(x[:, 0])
        strings, shapes = [out["strings"]], [out["shape"]]
        for i in range(1, x.shape[1]):
            x_ref, out = self.encode_inter(x[:, i], x_ref)
            strings.append(out["strings"])
            shapes.append(out["shape"])
        return strings, shapes

    # -- decompress --
    @torch.inference_mode()
    def decompress(self, strings, shapes, u8: bool = False):
        """strings, shapes: `compress`'s output. Returns (B, T, H, W, 3)
        numpy: float32 as decoded, or uint8 levels when `u8`."""
        self._check_updated()
        parts = _gop_parts(strings, shapes)
        set_wire_determinism()
        B = len(parts[0][1][0])
        if B == 1:
            return self._decompress_chunk(strings, shapes, u8)
        return np.concatenate(self._chunk_map(
            B, lambda i, codec: codec._decompress_chunk(
                [_slice_strings(s, i, i + 1) for s in strings], shapes, u8)))

    def decompress_async(self, strings, shapes, u8: bool = True):
        """Run the host halves of one sequence's GOP decode inline (z and y
        rANS, the indexes' copy), dispatch the frame chain and start the
        frames' copy to the host; the finalizer waits for that copy. A
        multi-sequence batch is decoded here and the finalizer returns
        it."""
        self._check_updated()
        parts = _gop_parts(strings, shapes)
        if len(parts[0][1][0]) > 1:
            out = self.decompress(strings, shapes, u8=u8)
            return lambda: out
        return self._decompress_chunk(strings, shapes, u8, _async=True)

    @torch.inference_mode()
    def _decompress_chunk(self, strings, shapes, u8: bool = False,
                          _async: bool = False):
        """Whole-GOP decode of one sequence: host rANS of every z stream,
        one upload of their symbols, one fetch of every part's scale
        indexes, host rANS of every y stream, one upload of their symbols,
        the frame chain, one fetch of the stacked frames (or, `_async`, a
        finalizer that waits for that fetch)."""
        set_wire_determinism()
        sts = self.hp_states
        parts = _gop_parts(strings, shapes)
        t0 = time.perf_counter()
        z_sym = np.concatenate([sts[which].decode_z(s[1], shape)
                                for which, s, shape in parts])
        t0 = self._stat("dec_z_rans_ms", t0)
        idx, means = self._gop_params(_to_device(
            z_sym.astype(_narrowest_int(z_sym)), self.device))
        idx = _Fetch(idx).result()
        t0 = self._stat("dec_idx_fetch_ms", t0)
        y_sym = np.concatenate([sts[which].decode_y(s[0], idx[k:k + 1])
                                for k, (which, s, _) in enumerate(parts)])
        t0 = self._stat("dec_y_rans_ms", t0)
        frames = self._gop_frames(_to_device(
            y_sym.astype(_narrowest_int(y_sym)), self.device), means)
        fetch = _Fetch(self._pixels_out(frames, u8))
        if not _async:
            self._sync()
        self._stat("dec_device_ms", t0)

        def finalize():
            t1 = time.perf_counter()
            out = fetch.result()
            self._stat("dec_fetch_ms", t1)
            return out

        return finalize if _async else finalize()

    @torch.inference_mode()
    def _decompress_chunk_sync(self, strings, shapes, u8: bool = False):
        """The per-frame chain: the same frames as `_decompress_chunk`."""
        x_ref = self.decode_keyframe(strings[0], shapes[0])
        frames = [x_ref]
        for i in range(1, len(strings)):
            x_ref = self.decode_inter(x_ref, strings[i], shapes[i])
            frames.append(x_ref)
        return self._pixels_out(torch.stack(frames, dim=1), u8).cpu().numpy()
