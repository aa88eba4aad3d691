"""Host-side codec wrappers: transforms on the device, rANS on the host.

Counterpart of lmic_tpu/models/codec.py:51-783 (`FactorizedPriorCodec`,
`HyperpriorCodec`), with the same API and the same wire:
`compress(x) -> {"strings", "shape"}` for NHWC numpy images (float in
[0, 1] or uint8), `decompress(strings, shape, u8=False) -> {"x_hat"}`.

Wire determinism (the rules of lmic_tpu/models/codec.py `_PerItem`):

- every graph whose output reaches the bitstream (the analysis transforms
  and the hyper synthesis that picks the scale buckets) runs one image at a
  time (batch size 1), under `set_wire_determinism()`, so symbols and
  indexes do not depend on how images are batched;
- `HyperpriorCodec._params_from_zsym` is the only place the entropy
  parameters are derived, from the wire z symbols, on the encode side and
  on the decode side alike.

Symbols leave the device as int8 when they fit (int16, then int32, when
they do not), and scale indexes as uint8.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from lmic_tpu_torch import default_device
from lmic_tpu_torch.entropy import coder as rans
from lmic_tpu_torch.entropy.entropy_models import (
    EBState,
    GaussianConditional,
    GCState,
    eb_update,
    get_scale_table,
)
from lmic_tpu_torch.utils.determinism import set_wire_determinism

_NARROW = (torch.int8, torch.int16, torch.int32)


def _symbols_to_host(sym: torch.Tensor) -> np.ndarray:
    """Integral-valued float tensor -> int32 numpy, crossing to the host in
    the narrowest integer type that holds every value."""
    lo, hi = (int(v) for v in torch.aminmax(sym))
    for dt in _NARROW:
        info = torch.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            break
    return sym.to(dt).cpu().numpy().astype(np.int32)


def _narrowest_int(sym: np.ndarray):
    if sym.size and sym.min() >= -128 and sym.max() <= 127:
        return np.int8
    if sym.size and sym.min() >= -(1 << 15) and sym.max() < (1 << 15):
        return np.int16
    return np.int32


def _image_out(x: torch.Tensor, u8: bool) -> Dict[str, Any]:
    """A synthesis output (B, C, H, W) -> {"x_hat": NHWC numpy}, clipped to
    [0, 1] (uint8 levels when `u8`)."""
    x = torch.clamp(x, 0.0, 1.0)
    if u8:
        x = torch.round(x * 255.0).to(torch.uint8)
    return {"x_hat": np.ascontiguousarray(x.permute(0, 2, 3, 1).cpu().numpy())}


class CompressionCodec:
    """Base wrapper: module + coding state + the device it runs on."""

    def __init__(self, module: torch.nn.Module, device=None):
        self.device = default_device(device)
        self.module = module.to(self.device, memory_format=torch.channels_last)
        self.module.eval()
        self.eb_state: Optional[EBState] = None
        self.gc_state: Optional[GCState] = None
        # wall-clock ms of the stages of the LAST compress/decompress call
        self.stats: Dict[str, float] = {}
        set_wire_determinism()

    def _stat(self, key: str, t0: float) -> float:
        now = time.perf_counter()
        self.stats[key] = (now - t0) * 1e3
        return now

    def _pixels(self, x: np.ndarray) -> torch.Tensor:
        """(B, H, W, C) numpy -> NCHW channels_last float32 on the device;
        uint8 maps to [0, 1] as x / 255."""
        t = torch.tensor(x, device=self.device).permute(0, 3, 1, 2)
        if t.dtype == torch.uint8:
            return t.float() / 255.0
        return t.float()

    def _upload(self, sym: np.ndarray) -> torch.Tensor:
        """int32 symbols (B, C, h, w) -> float32 on the device, crossing as
        the narrowest integer type."""
        sym = np.ascontiguousarray(sym.astype(_narrowest_int(sym)))
        t = torch.from_numpy(sym).to(self.device).float()
        return t.contiguous(memory_format=torch.channels_last)

    def _synthesize(self, y_hat: torch.Tensor, u8: bool) -> Dict[str, Any]:
        """g_s on dequantized latents -> {"x_hat": NHWC numpy}, clipped to
        [0, 1] (uint8 levels when `u8`)."""
        y_hat = y_hat.contiguous(memory_format=torch.channels_last)
        return _image_out(self.module.g_s(y_hat), u8)

    def _medians(self, state: EBState) -> torch.Tensor:
        return torch.from_numpy(state.medians).to(self.device).view(
            1, -1, 1, 1
        )

    def _check_dims(self, x: np.ndarray):
        """Hyperprior streams only round-trip when H, W are multiples of
        the downsampling factor: the decoder re-derives the y geometry by
        upsampling z. Fail loudly instead of desyncing."""
        factor = self.module.downsampling_factor
        H, W = x.shape[1:3]
        if H % factor or W % factor:
            raise ValueError(
                f"input spatial dims ({H}, {W}) must be multiples of "
                f"{factor}; pad first (CLIs use centered padding)"
            )


class FactorizedPriorCodec(CompressionCodec):
    """bmshj2018-factorized coding wrapper."""

    def update(self, force: bool = False):
        if self.eb_state is not None and not force:
            return False
        self.eb_state = eb_update(self.module.entropy_bottleneck)
        return True

    def _check_updated(self):
        if self.eb_state is None:
            raise RuntimeError("Uninitialized CDFs. Run update() first")

    @torch.inference_mode()
    def compress(self, x):
        """x: (B, H, W, C) float in [0, 1] or uint8."""
        self._check_updated()
        set_wire_determinism()
        x = np.asarray(x)
        t0 = time.perf_counter()
        med = self._medians(self.eb_state)
        sym = np.concatenate([
            _symbols_to_host(torch.round(
                self.module.g_a(self._pixels(x[i:i + 1])) - med
            ))
            for i in range(x.shape[0])
        ])
        t0 = self._stat("enc_device_ms", t0)
        B, C, h, w = sym.shape
        indexes = np.repeat(np.arange(C, dtype=np.int32), h * w)
        strings = rans.encode_batch(sym.reshape(B, -1), indexes,
                                    self.eb_state.table)
        self._stat("enc_rans_ms", t0)
        return {"strings": [strings], "shape": (h, w)}

    @torch.inference_mode()
    def decompress(self, strings, shape, u8: bool = False):
        self._check_updated()
        if not isinstance(strings, list) or len(strings) != 1:
            raise ValueError("factorized streams have one string group")
        set_wire_determinism()
        t0 = time.perf_counter()
        sym = self.eb_state.decode_symbols(strings[0], tuple(shape))
        t0 = self._stat("dec_rans_ms", t0)
        y_hat = self._upload(sym) + self._medians(self.eb_state)
        out = self._synthesize(y_hat, u8)
        self._stat("dec_device_ms", t0)
        return out


class HyperpriorCodec(CompressionCodec):
    """Coding wrapper for ScaleHyperprior / MeanScaleHyperprior.

      encode: x -> y, z (per image); z symbols -> (sigma, mu) -> indexes
              (per image, `_params_from_zsym`); y symbols = round(y - mu)
      decode: z symbols -> the same `_params_from_zsym`; y symbols -> g_s
    """

    gc = GaussianConditional()

    def update(self, force: bool = False, scale_table=None):
        if (self.eb_state is not None and self.gc_state is not None
                and not force):
            return False
        self.eb_state = eb_update(self.module.entropy_bottleneck)
        if scale_table is None:
            scale_table = get_scale_table()
        self.gc_state = self.gc.update(scale_table)
        return True

    def _check_updated(self):
        if self.eb_state is None or self.gc_state is None:
            raise RuntimeError("Uninitialized CDFs. Run update() first")

    def _params_from_zsym(self, z_sym: np.ndarray):
        """Entropy parameters as a function of the WIRE z symbols (int32,
        channel-major (B, C, h, w)), one image at a time. The only place
        they are derived, on both sides of the wire. Returns (indexes int32
        (B, M, H, W) on the host, means on the device or None)."""
        z_med = self._medians(self.eb_state)
        table = torch.from_numpy(self.gc_state.scale_table).to(self.device)
        idx, means = [], []
        for i in range(z_sym.shape[0]):
            z_hat = self._upload(z_sym[i:i + 1]) + z_med
            scales, mu = self.module.hyper_to_params(z_hat)
            idx.append(self.gc.build_indexes(table, scales).to(torch.uint8))
            means.append(mu)
        idx = torch.cat(idx).cpu().numpy().astype(np.int32)
        return idx, (None if means[0] is None else torch.cat(means))

    def _analyze(self, x: np.ndarray):
        """The encoder's transforms, one image at a time: (list of B
        latents y (1, M, H, W) on the device, wire z symbols int32
        (B, C, h, w) on the host)."""
        z_med = self._medians(self.eb_state)
        ys, z_syms = [], []
        for i in range(x.shape[0]):
            y, z = self.module.analyze(self._pixels(x[i:i + 1]))
            ys.append(y)
            z_syms.append(_symbols_to_host(torch.round(z - z_med)))
        return ys, np.concatenate(z_syms)

    def _encode_z(self, z_sym: np.ndarray):
        """Wire z symbols -> the bottleneck's strings, channel-major."""
        B, Cz, h, w = z_sym.shape
        return rans.encode_batch(
            z_sym.reshape(B, -1),
            np.repeat(np.arange(Cz, dtype=np.int32), h * w),
            self.eb_state.table,
        )

    @torch.inference_mode()
    def compress(self, x):
        """x: (B, H, W, C) float in [0, 1] or uint8; H, W multiples of 64."""
        self._check_updated()
        x = np.asarray(x)
        self._check_dims(x)
        set_wire_determinism()
        t0 = time.perf_counter()
        ys, z_sym = self._analyze(x)
        idx, means = self._params_from_zsym(z_sym)
        y = torch.cat(ys)
        y_sym = _symbols_to_host(
            torch.round(y - means if means is not None else y)
        )
        t0 = self._stat("enc_device_ms", t0)
        B, _, h, w = z_sym.shape
        z_strings = self._encode_z(z_sym)
        y_strings = rans.encode_batch(
            y_sym.reshape(B, -1), idx.reshape(B, -1), self.gc_state.table
        )
        self._stat("enc_rans_ms", t0)
        return {"strings": [y_strings, z_strings], "shape": (h, w)}

    @torch.inference_mode()
    def decompress(self, strings, shape, u8: bool = False):
        self._check_updated()
        if not isinstance(strings, list) or len(strings) != 2:
            raise ValueError("hyperprior streams have two string groups")
        set_wire_determinism()
        y_strings, z_strings = strings
        t0 = time.perf_counter()
        z_sym = self.eb_state.decode_symbols(z_strings, tuple(shape))
        t0 = self._stat("dec_z_rans_ms", t0)
        idx, means = self._params_from_zsym(z_sym)
        t0 = self._stat("dec_params_ms", t0)
        B = idx.shape[0]
        y_sym = rans.decode_batch(
            y_strings, idx.reshape(B, -1), self.gc_state.table
        ).reshape(idx.shape)
        t0 = self._stat("dec_y_rans_ms", t0)
        y_hat = self._upload(y_sym)
        if means is not None:
            y_hat = y_hat + means
        out = self._synthesize(y_hat, u8)
        self._stat("dec_device_ms", t0)
        return out
