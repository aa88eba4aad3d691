"""Joint autoregressive + hierarchical priors (mbt2018) and its wavefront
codec.

Counterpart of lmic_tpu/models/joint.py:47-249, 308-620 (reference
compressai/models/google.py:421-692). The context model's serial
dependency is a **wavefront**: with the 5x5 type-A causal mask, latent
pixel (h, w) depends only on pixels with 3h' + w' < 3h + w, so the pixels
of t = 3h + w are coded together, one step per wavefront (3H + W - 3 steps
instead of H*W). Each step computes the context features, the entropy
parameters MLP and the scale indexes of its pixels on the device.

Bitstream symbol order (lmic_tpu's format): wavefront-major (t
ascending), h ascending within a wavefront, channel-minor. It comes from
the step's buffer `y_hat_pad`, kept `(H + 4, W + 4, M)` in HWC order as
in lmic_tpu (as rows of a `((H + 4) * (W + 4), M)` view), not from the
port's NCHW layout.

The reference app's order (`order="raster"`, the symbols of
`--container reference` files): pixel-major in raster order (h outer, w
inner), channel-minor, one pixel a step (H * W steps). It is the same
step on a schedule of one pixel per step (`raster_schedule`), so encode
and decode share it as in the wavefront order (lmic_tpu's
`_get_raster_scans` over `step_fn.pixel_params`,
lmic_tpu/models/joint.py:839-983). The decode loop makes H * W host round
trips, each with one rANS decode of M symbols: a compatibility path, not
a fast one.

Wire determinism: encode and decode run the same step at the same shapes
on the same device, one image at a time, so scales and means agree bit
for bit on both sides; the step never waits for the device, so the encode
loop queues all T steps and copies its symbols and indexes to the host
once. The decode loop copies each wavefront's indexes to the host, decodes
its symbols with the host rANS decoder, and sends them back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lmic_tpu_torch.entropy import coder as rans
from lmic_tpu_torch.entropy import entropy_models
from lmic_tpu_torch.layers import Conv, MaskedConv2d, remat
from lmic_tpu_torch.models.codec import (
    HyperpriorCodec,
    _AnalyzeU8,
    _Fetch,
    _PackSymbols,
    _PerItem,
    _SynthU8,
    _symbols_to_host,
    _to_device,
)
from lmic_tpu_torch.models.image import MeanScaleHyperprior
from lmic_tpu_torch.ops.math import from_amp
from lmic_tpu_torch.utils.determinism import set_wire_determinism

KERNEL = 5
PAD = (KERNEL - 1) // 2
# the live taps of the type-A mask: the PAD rows above the centre whole,
# then the centre row left of the centre (make_causal_mask)
TAPS = [(i, j) for i in range(PAD) for j in range(KERNEL)] + [
    (PAD, j) for j in range(PAD)
]


class JointAutoregressiveHierarchicalPriors(MeanScaleHyperprior):
    """mbt2018: the mean-scale hyperprior plus a masked-conv context model
    and the entropy parameters MLP (1x1 convs 4M -> 10M/3 -> 8M/3 -> 2M).
    Both stay f32 whatever `dtype` is, as in lmic_tpu."""

    def __init__(self, N: int, M: int, channel: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(N, M, channel=channel, generator=generator,
                         dtype=dtype)
        self.entropy_parameters = nn.Sequential(
            Conv(M * 12 // 3, M * 10 // 3, 1, 1), nn.LeakyReLU(0.01),
            Conv(M * 10 // 3, M * 8 // 3, 1, 1), nn.LeakyReLU(0.01),
            Conv(M * 8 // 3, M * 6 // 3, 1, 1),
        )
        self.context_prediction = MaskedConv2d(M, 2 * M, KERNEL, "A")

    def hyper_to_params(self, z_hat):
        """z_hat -> the hyper params at y's resolution, 2M channels, NOT
        split: the split comes after the fusion with the context."""
        return from_amp(self.h_s(z_hat))

    def param_fuse(self, hyper_p, ctx_p):
        """(B, 2M, ...) hyper + (B, 2M, ...) context -> (scales, means)."""
        gaussian_params = self.entropy_parameters(
            torch.cat([hyper_p, ctx_p], dim=1))
        scales, means = gaussian_params.chunk(2, dim=1)
        return scales, means

    def _context_params(self, hyper_p, y_hat):
        """The context model and the entropy parameters on the quantized
        latent: (scales, means). One block of `remat` in training."""
        return self.param_fuse(hyper_p, self.context_prediction(y_hat))

    def _entropy_forward(self, y, training: bool,
                         generator: Optional[torch.Generator]):
        """The latent y -> {"y_hat": the context's (and g_s's) input,
        "likelihoods"}: hyperprior, context model and entropy parameters,
        shared by the forwards of this model and the RGB-T pair."""
        z = from_amp(self.h_a(y))
        z_hat, z_likelihoods = self.entropy_bottleneck(
            z, training=training, generator=generator
        )
        params = self.hyper_to_params(z_hat)
        # the context's input is quantized WITHOUT the means (reference
        # google.py:500-502)
        if training:
            y_hat = entropy_models.quantize_noise(y, generator)
        else:
            y_hat = torch.round(y)
        scales_hat, means_hat = remat.run(self._context_params, params,
                                          y_hat)
        _, y_likelihoods = self.gaussian_conditional(
            y, scales_hat, means=means_hat, training=training,
            generator=generator,
        )
        return {"y_hat": y_hat,
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def forward(self, x, training: bool = True,
                generator: Optional[torch.Generator] = None):
        out = self._entropy_forward(from_amp(self.g_a(x)), training,
                                    generator)
        return {"x_hat": from_amp(self.g_s(out.pop("y_hat"))),
                "likelihoods": out["likelihoods"]}


# ---------------------------------------------------------------------------
# The wavefront step
# ---------------------------------------------------------------------------


def _wavefront_positions(H: int, W: int) -> int:
    """Number of wavefronts: step t covers pixels (h, t - 3h)."""
    return 3 * (H - 1) + (W - 1) + 1


def wavefront_rows(H: int, W: int) -> int:
    """Most rows valid at once on a wavefront t = 3h + w: ceil(W/3) + 1,
    clamped to H. Each step works on a window of this many rows."""
    return min(H, (W + 2) // 3 + 1)


@dataclasses.dataclass
class WavefrontSchedule:
    """The wavefronts of an H x W latent, computed on the host once and
    uploaded once, so a step indexes them with the host integer t.

    Host (numpy): `valid` (T, R), which window rows hold a pixel, as
    lmic_tpu's step returns it; `lo`, `hi` (T,): the valid rows of step t
    are the window rows lo..hi-1 (0 <= t - 3h < W is an interval of h).
    Device (int64): `pix` (T, R), row h*W + w of an (H*W, ...) HWC view
    (w clipped to the image on invalid rows, as lmic_tpu's `w_safe`);
    `pad` (T, R), row of the padded buffer; `taps` (T, R, 12), the buffer
    rows of the live taps; `order` (H*W,), the valid rows of the
    (T*R, ...) step outputs in wavefront order."""

    H: int
    W: int
    T: int
    R: int
    valid: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    pix: torch.Tensor
    pad: torch.Tensor
    taps: torch.Tensor
    order: torch.Tensor


def wavefront_schedule(H: int, W: int, device) -> WavefrontSchedule:
    T, R = _wavefront_positions(H, W), wavefront_rows(H, W)
    t = np.arange(T)[:, None]
    # valid h: ceil((t - W + 1) / 3) <= h <= t // 3; clamp the R-window
    h0 = np.clip((t - W + 3) // 3, 0, H - R)
    h_vec = h0 + np.arange(R)
    w_vec = t - 3 * h_vec
    valid = (w_vec >= 0) & (w_vec < W)
    w_safe = np.clip(w_vec, 0, W - 1)
    lo = valid.argmax(1)
    hi = lo + valid.sum(1)
    Wp = W + 2 * PAD
    taps = np.stack([(h_vec + i) * Wp + (w_safe + j) for i, j in TAPS], -1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    return WavefrontSchedule(
        H=H, W=W, T=T, R=R, valid=valid, lo=lo, hi=hi,
        pix=dev(h_vec * W + w_safe),
        pad=dev((h_vec + PAD) * Wp + w_safe + PAD), taps=dev(taps),
        order=dev(np.flatnonzero(valid.reshape(-1))),
    )


def raster_schedule(H: int, W: int, device) -> WavefrontSchedule:
    """The reference's raster order as a schedule of one pixel per step:
    step t codes pixel (t // W, t % W), so T = H * W and R = 1."""
    p = np.arange(H * W)[:, None]
    h, w = p // W, p % W
    Wp = W + 2 * PAD
    taps = np.stack([(h + i) * Wp + (w + j) for i, j in TAPS], -1)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    return WavefrontSchedule(
        H=H, W=W, T=H * W, R=1, valid=np.ones((H * W, 1), bool),
        lo=np.zeros(H * W, np.int64), hi=np.ones(H * W, np.int64),
        pix=dev(p), pad=dev((h + PAD) * Wp + w + PAD), taps=dev(taps),
        order=dev(np.arange(H * W)),
    )


ORDERS = {"wavefront": wavefront_schedule, "raster": raster_schedule}


@torch.no_grad()
def make_wavefront_step(module, sched: WavefrontSchedule, scale_table):
    """The per-wavefront computation shared by encode and decode (the
    counterpart of lmic_tpu's `make_wavefront_step`, same algebra, so the
    CPU sums agree with lmic_tpu's). Returns `(prepare, step)`:

    - `prepare(params)`: (1, 2M, H, W) hyper params -> (H*W, 10M/3)
      pre-activations of the MLP's first layer, hyper half:
      `params @ w1_hyper + (b1 + ctx_bias @ w1_ctx)`, once per image (the
      first 1x1 conv acts on concat(hyper, ctx), and the masked conv's
      bias is constant, so both fold into this term);
    - `step(t, y_hat_pad, pre1)`: for the R window rows of wavefront t,
      the context of the 12 live taps (one (R, 12M) x (12M, 2M) product),
      `h1 = pre1[pix] + ctx @ w1_ctx`, the two tail layers and the scale
      indexes. Returns (scales, means, indexes), each (R, M). `t` is a
      host integer; the step queues device work and never waits for it.
    """
    M = module.M
    weight = module.context_prediction.weight.permute(2, 3, 1, 0)  # HWIO
    tap_kernel = torch.cat([
        weight[:PAD].reshape(PAD * KERNEL, M, 2 * M), weight[PAD, :PAD],
    ]).reshape(len(TAPS) * M, 2 * M)
    ctx_bias = module.context_prediction.bias
    ep = module.entropy_parameters
    w1, w2, w3 = (ep[i].weight[:, :, 0, 0].t().contiguous()
                  for i in (0, 2, 4))
    b1, b2, b3 = (ep[i].bias for i in (0, 2, 4))
    # concat order in param_fuse is [hyper, ctx]
    w1_hyper, w1_ctx = w1[:2 * M], w1[2 * M:]
    pre_bias = b1 + ctx_bias @ w1_ctx
    table = torch.as_tensor(np.asarray(scale_table, np.float32),
                            device=tap_kernel.device)
    gc = entropy_models.GaussianConditional()
    H, W, R = sched.H, sched.W, sched.R

    def prepare(params):
        hwc = params[0].permute(1, 2, 0).reshape(H * W, 2 * M)
        return hwc @ w1_hyper + pre_bias

    def step(t: int, y_hat_pad, pre1):
        taps = y_hat_pad[sched.taps[t]].view(R, -1)
        ctx = taps @ tap_kernel  # (R, 2M); its bias is in pre_bias
        h1 = pre1[sched.pix[t]] + ctx @ w1_ctx
        a1 = F.leaky_relu(h1, 0.01)
        a2 = F.leaky_relu(a1 @ w2 + b2, 0.01)
        fused = a2 @ w3 + b3
        scales, means = fused[:, :M], fused[:, M:]
        return scales, means, gc.build_indexes(table, scales)

    return prepare, step


def _scatter_wavefront(y_hat_pad, sched: WavefrontSchedule, t: int,
                       y_vals):
    """Write the values of wavefront t's valid rows (hi - lo, M) into the
    padded buffer (their rows are distinct); the rest of it is kept."""
    y_hat_pad.index_copy_(0, sched.pad[t, sched.lo[t]:sched.hi[t]], y_vals)


def _new_buffer(sched: WavefrontSchedule, M: int, device):
    return torch.zeros(((sched.H + 2 * PAD) * (sched.W + 2 * PAD), M),
                       device=device)


def _latent(y_hat_pad, sched: WavefrontSchedule):
    """Padded HWC buffer rows -> (1, M, H, W) channels_last."""
    M = y_hat_pad.shape[1]
    hwc = y_hat_pad.view(sched.H + 2 * PAD, sched.W + 2 * PAD, M)
    return hwc[PAD:PAD + sched.H, PAD:PAD + sched.W].permute(
        2, 0, 1)[None].contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------


class JointARCodec(HyperpriorCodec):
    """Codec wrapper for mbt2018 and the cheng2020 models, which share its
    entropy path (lmic_tpu/models/joint.py:319-620).

      encode: x -> y, z (per image); z symbols -> hyper params (per image,
              `_hyper_params`); T wavefront steps on the device; one copy
              of the symbols and indexes; one rANS call per image
      decode: z symbols -> the same `_hyper_params`; T steps, each with a
              host rANS decode of its wavefront; g_s

    `stats` after compress: enc_analysis_ms, enc_loop_ms (hyper params and
    the steps, to the copy), enc_rans_ms (z and y); after decompress:
    dec_z_ms, dec_loop_ms and its parts dec_loop_device_ms (the steps, the
    copies and the waits) and dec_loop_rans_ms (host rANS),
    dec_synthesis_ms.
    """

    def _hyper_params(self, z_sym: np.ndarray):
        """(1, 2M, H, W) hyper params of ONE image from its wire z symbols
        (1, C, h, w): the same graph on both sides of the wire, at batch 1
        (the counterpart of lmic_tpu's `_params_on_scan_device`)."""
        z_hat = self._upload(z_sym) + self._medians(self.eb_state)
        return self.module.hyper_to_params(z_hat)

    def _step_for(self, H: int, W: int, order: str = "wavefront"):
        if order not in ORDERS:
            raise ValueError(f"order is one of {sorted(ORDERS)}, not "
                             f"{order!r}")
        sched = ORDERS[order](H, W, self.device)
        return sched, *make_wavefront_step(self.module, sched,
                                           self.gc_state.scale_table)

    def _encode_wavefronts(self, sched, prepare, step, y, params):
        """One image: y (1, M, H, W), params (1, 2M, H, W) -> symbols
        (H*W, M) float and indexes (H*W, M) int32 on the device in wire
        order, and the coded buffer."""
        M = y.shape[1]
        y_rows = y[0].permute(1, 2, 0).reshape(-1, M)
        y_hat_pad = _new_buffer(sched, M, self.device)
        pre1 = prepare(params)
        symbols = torch.empty((sched.T, sched.R, M), device=self.device)
        indexes = torch.empty((sched.T, sched.R, M), dtype=torch.int32,
                              device=self.device)
        for t in range(sched.T):
            _, means, idx = step(t, y_hat_pad, pre1)
            sym = torch.round(y_rows[sched.pix[t]] - means)
            y_vals = sym + means
            _scatter_wavefront(y_hat_pad, sched, t,
                               y_vals[sched.lo[t]:sched.hi[t]])
            symbols[t] = sym
            indexes[t] = idx
        return (symbols.view(-1, M)[sched.order],
                indexes.view(-1, M)[sched.order], y_hat_pad)

    def _code_y_z(self, ys: List[torch.Tensor], z_sym: np.ndarray,
                  keep_y_hat: bool = False, order: str = "wavefront"):
        """Entropy-code the latents ys (B of (1, M, H, W)) and the wire z
        symbols (B, C, h, w): z by the bottleneck, y by the wavefront loop
        (or the raster one, `order="raster"`). With keep_y_hat, also
        return the encoder's quantized latent (B, M, H, W) under
        "y_hat_latent": what decode must reproduce exactly."""
        t0 = time.perf_counter()
        M, H, W = ys[0].shape[1:]
        sched, prepare, step = self._step_for(H, W, order)
        syms, idxs, y_hats = [], [], []
        for i, y in enumerate(ys):
            params = self._hyper_params(z_sym[i:i + 1])
            sym, idx, y_hat_pad = self._encode_wavefronts(
                sched, prepare, step, y, params)
            syms.append(_symbols_to_host(sym))
            idxs.append(idx.cpu().numpy())
            if keep_y_hat:
                y_hats.append(_latent(y_hat_pad, sched))
        t0 = self._stat("enc_loop_ms", t0)
        z_strings = self._encode_z(z_sym)
        y_strings = rans.encode_batch(np.stack(syms), np.stack(idxs),
                                      self.gc_state.table)
        self._stat("enc_rans_ms", t0)
        out = {"strings": [y_strings, z_strings], "shape": z_sym.shape[2:]}
        if keep_y_hat:
            out["y_hat_latent"] = torch.cat(y_hats)
        return out

    def _build_u8_io(self):
        """The pixel ingest and egress of lmic_tpu's `_build_u8_io`: the
        analysis per image (`_PerItem`: y feeds the per-image wavefront
        loop, z becomes symbols), its z symbols as int8 with an overflow
        flag, and the synthesis of y_hat to uint8 pixels."""
        self._analyze_u8_ar = _PerItem(_AnalyzeU8(self.module,
                                                  self.eb_state.medians))
        self._g_s_u8 = _SynthU8(self.module)

    @torch.inference_mode()
    def compress_async(self, x, order: str = "wavefront"):
        """Dispatch the analysis (uint8 or float pixels) and start its z
        symbols' copy to the host; the finalizer runs the wavefront loop
        on the device and the host coder, so a caller overlaps the next
        batch's transforms with this batch's loop."""
        self._check_updated()
        x = np.asarray(x)
        self._check_dims(x)
        if order not in ORDERS:
            raise ValueError(f"order is one of {sorted(ORDERS)}, not "
                             f"{order!r}")
        self._ensure("_build_u8_io")
        set_wire_determinism()
        t0 = time.perf_counter()
        y, z8, zovf = self._analyze_u8_ar(_to_device(x, self.device))
        fetch = _Fetch(_PackSymbols()(z8, zovf))
        self._stat("enc_analysis_ms", t0)

        @torch.inference_mode()
        def finalize():
            t1 = time.perf_counter()
            buf = fetch.result()
            self._stat("enc_fetch_ms", t1)
            if buf[0]:  # a z symbol outside int8: the wide symbols
                ys, z_sym = self._analyze(x)
            else:
                ys = list(y.split(1))
                zshape = self._latent_shapes(*x.shape[:3])[0]
                z_sym = buf[1:].view(np.int8).reshape(zshape).astype(
                    np.int32)
            return self._code_y_z(ys, z_sym, order=order)

        return finalize

    def compress(self, x, order: str = "wavefront"):
        """x: (B, H, W, C) float in [0, 1] or uint8; H, W multiples of 64.
        `order="raster"` writes the reference app's symbol order
        (google.py:565-608), for `--container reference` files."""
        return self.compress_async(x, order)()

    def _decode_wavefronts(self, sched, prepare, step, stream, params,
                           times):
        """One image's y stream -> its coded buffer; adds the host seconds
        of device work and of rANS to `times`."""
        M = self.module.M
        table = self.gc_state.table
        dec = rans.RansDecoder()
        dec.set_stream(stream)
        y_hat_pad = _new_buffer(sched, M, self.device)
        pre1 = prepare(params)
        for t in range(sched.T):
            t0 = time.perf_counter()
            lo, hi = int(sched.lo[t]), int(sched.hi[t])
            _, means, idx = step(t, y_hat_pad, pre1)
            idx = idx[lo:hi].cpu().numpy()  # waits for the step
            t1 = time.perf_counter()
            sym = dec.decode_stream(idx, table)
            t2 = time.perf_counter()
            sym = torch.from_numpy(sym).view(hi - lo, M).to(self.device)
            _scatter_wavefront(y_hat_pad, sched, t,
                               sym.float() + means[lo:hi])
            times[0] += (t1 - t0) + (time.perf_counter() - t2)
            times[1] += t2 - t1
        return y_hat_pad

    def _decode_y_hat(self, strings, shape,
                      order: str = "wavefront") -> torch.Tensor:
        """The AR latent y_hat (B, M, H, W) of the streams, on the device,
        one image at a time, in the streams' symbol `order`."""
        if not isinstance(strings, list) or len(strings) != 2:
            raise ValueError("AR streams have two string groups")
        y_strings, z_strings = strings
        t0 = time.perf_counter()
        z_sym = self.eb_state.decode_symbols(z_strings, tuple(shape))
        t0 = self._stat("dec_z_ms", t0)
        H, W = 4 * int(shape[0]), 4 * int(shape[1])
        sched, prepare, step = self._step_for(H, W, order)
        times = [0.0, 0.0]
        y_hat = torch.cat([
            _latent(self._decode_wavefronts(
                sched, prepare, step, s,
                self._hyper_params(z_sym[i:i + 1]), times), sched)
            for i, s in enumerate(y_strings)
        ])
        self._stat("dec_loop_ms", t0)
        self.stats["dec_loop_device_ms"] = 1e3 * times[0]
        self.stats["dec_loop_rans_ms"] = 1e3 * times[1]
        return y_hat

    @torch.inference_mode()
    def decompress(self, strings, shape, u8: bool = False,
                   order: str = "wavefront"):
        self._check_updated()
        set_wire_determinism()
        y_hat = self._decode_y_hat(strings, shape, order)
        t0 = time.perf_counter()
        out = self._synthesize(y_hat, u8)
        self._stat("dec_synthesis_ms", t0)
        return out

    @torch.inference_mode()
    def decompress_async(self, strings, shape, u8: bool = True,
                         order: str = "wavefront"):
        """Run the serial decode loop inline, dispatch the synthesis (to
        uint8 pixels by default) and start its copy to the host; the
        finalizer waits for that copy."""
        self._check_updated()
        set_wire_determinism()
        y_hat = self._decode_y_hat(strings, shape, order)
        t0 = time.perf_counter()
        if u8:
            self._ensure("_build_u8_io")
            x = self._g_s_u8(y_hat)
        else:
            x = torch.clamp(self.module.g_s(y_hat), 0.0, 1.0).permute(
                0, 2, 3, 1).contiguous()
        fetch = _Fetch(x)
        self._stat("dec_synthesis_ms", t0)

        def finalize():
            t1 = time.perf_counter()
            out = fetch.result()
            self._stat("dec_fetch_ms", t1)
            return {"x_hat": out}

        return finalize
