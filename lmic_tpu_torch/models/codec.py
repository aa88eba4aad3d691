"""Host-side codec wrappers: transforms on the device, rANS on the host.

Counterpart of lmic_tpu/models/codec.py:51-783 (`FactorizedPriorCodec`,
`HyperpriorCodec`), with the same API and the same wire:
`compress(x) -> {"strings", "shape"}` for NHWC numpy images (float in
[0, 1] or uint8), `decompress(strings, shape, u8=False) -> {"x_hat"}`,
and the pipelined pair `compress_async(x)` / `decompress_async(strings,
shape)`, each returning a finalizer.

Wire determinism (the rules of lmic_tpu/models/codec.py `_PerItem`):

- every graph whose output reaches the bitstream (the analysis transforms
  and the hyper synthesis that picks the scale buckets) runs one image at a
  time (batch size 1, `_PerItem`), under `set_wire_determinism()`, so
  symbols and indexes do not depend on how images are batched;
- `HyperpriorCodec._params_from_zsym` is the only place the entropy
  parameters are derived, from the wire z symbols, on the encode side and
  on the decode side alike.

The uint8 fast path (`_build_u8_fns`, lmic_tpu's device functions of the
same names) is a set of modules on tensors with no host read inside:
pixels cross to the device as uint8, symbols come back as int8 (int16 when
one overflows, flagged on the device; past int16 the plain path's int32)
and scale indexes as uint8, the whole encode result in one packed buffer. `compress_async` dispatches them
and starts that buffer's copy to pinned host memory; its finalizer waits on
the copy's CUDA event (never on the whole device) and runs the host rANS.
The same modules serve the synchronous uint8 calls and are what
`utils/aot.py` exports. Float input keeps the plain path, symbols crossing
in the narrowest integer type that holds them.

Every path reads the bf16 matmul precision (`ops/precision.py`,
`eval_model --half`) in its layers at each call, never when its modules
are built, so one codec codes in f32 and under the mode in one process;
the tables do not depend on it (the bottleneck's density stays f32).
"""

from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from lmic_tpu_torch import default_device
from lmic_tpu_torch.entropy import coder as rans
from lmic_tpu_torch.entropy.entropy_models import (
    EBState,
    GaussianConditional,
    GCState,
    eb_update,
    get_scale_table,
)
from lmic_tpu_torch.ops import precision
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


def _u8_pixels(x: torch.Tensor) -> torch.Tensor:
    """A synthesis output (B, C, H, W) -> uint8 levels round(clip(x, 0, 1)
    * 255), NHWC contiguous."""
    x = torch.round(torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)
    return x.permute(0, 2, 3, 1).contiguous()


def _image_out(x: torch.Tensor, u8: bool) -> Dict[str, Any]:
    """A synthesis output (B, C, H, W) -> {"x_hat": NHWC numpy}, clipped to
    [0, 1] (uint8 levels when `u8`)."""
    if u8:
        return {"x_hat": _u8_pixels(x).cpu().numpy()}
    x = torch.clamp(x, 0.0, 1.0)
    return {"x_hat": np.ascontiguousarray(x.permute(0, 2, 3, 1).cpu().numpy())}


# -- host <-> device copies of the fast path ---------------------------------


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array -> a tensor on `device`. On CUDA through a pinned
    staging buffer and a non-blocking copy: a copy from pageable memory
    waits for the stream's earlier work, which would serialize a pipelined
    caller's batches (PyTorch's pinned allocator keeps the buffer until
    the copy has run)."""
    arr = np.ascontiguousarray(arr)
    if device.type != "cuda":
        return torch.tensor(arr, device=device)
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    buf = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    buf.numpy()[...] = arr
    return buf.to(device, non_blocking=True)


class _Fetch:
    """A device tensor's copy to pinned host memory, started when made:
    `result()` waits on the copy's CUDA event, never on the whole device,
    and returns the host array. Holds the source until then. On the CPU
    the tensor already is the result."""

    def __init__(self, t: torch.Tensor):
        self._src, self._event = t, None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))
        else:
            self._host = t

    def result(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return self._host.numpy()


# -- the device functions of the uint8 fast path -----------------------------


def _only(module: nn.Module, *paths: str) -> nn.Module:
    """A shallow copy of `module` that holds only the submodules at the
    dotted `paths` (and those on the way to them): its methods run as on
    `module`, on the same weights, and an export of it carries only those
    weights."""
    heads: Dict[str, list] = {}
    for p in paths:
        head, _, rest = p.partition(".")
        heads.setdefault(head, []).append(rest)
    view = copy.copy(module)
    view.__dict__["_modules"] = {
        name: sub if "" in heads[name] else _only(sub, *heads[name])
        for name, sub in module._modules.items() if name in heads}
    view.__dict__["_parameters"] = {}
    view.__dict__["_buffers"] = {}
    return view


def _cl(t: torch.Tensor) -> torch.Tensor:
    """channels_last, the layout of every input of a sub-network on both
    sides of the wire (a conv may pick another algorithm for another
    layout, and so compute other last bits)."""
    return t.contiguous(memory_format=torch.channels_last)


def _const(module: nn.Module, arr, *shape) -> torch.Tensor:
    """A float32 copy of `arr` on the device of `module`'s weights, owning
    its memory (an exported graph stores a view's whole storage)."""
    dev = next(module.parameters()).device
    return torch.tensor(np.asarray(arr, np.float32), device=dev).view(*shape)


def _overflow(sym: torch.Tensor) -> torch.Tensor:
    """How far the symbols overflow, as an int32 (1,) tensor: 0 when all
    fit int8, 1 when one needs int16, 2 when one is past int16 (the plain
    path's int32 symbols then)."""
    past8 = ((sym < -128) | (sym > 127)).any()
    past16 = ((sym < -32768) | (sym > 32767)).any()
    return (past8.to(torch.int32) + past16.to(torch.int32)).reshape(1)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """An int8 tensor's bytes, flat (a reinterpretation, not a cast)."""
    return t.reshape(-1).view(torch.uint8)


def _pixels_in(x: torch.Tensor) -> torch.Tensor:
    """NHWC pixels -> NCHW float32 (channels_last in memory); uint8 maps to
    [0, 1] as x / 255."""
    x = x.permute(0, 3, 1, 2)
    return x.float() / 255.0 if x.dtype == torch.uint8 else x.float()


class _EncU8(nn.Module):
    """Factorized `_enc_u8_packed`'s per-image graph (`wide=False`):
    uint8 (1, H, W, C) -> (int8 symbols (1, M, h, w) channel-major, int32
    (1,) overflow level, `_overflow`); `wide=True` is the `_enc_u8`
    escape: int16 symbols alone."""

    def __init__(self, module, medians: np.ndarray, wide: bool = False):
        super().__init__()
        self.module = _only(module, "g_a")
        self.wide = wide
        self.register_buffer("medians", _const(module, medians, 1, -1, 1, 1))

    def forward(self, x_u8):
        sym = torch.round(self.module.g_a(_pixels_in(x_u8)) - self.medians)
        if self.wide:
            return sym.to(torch.int16).contiguous()
        return sym.to(torch.int8).contiguous(), _overflow(sym)


class _PackSymbols(nn.Module):
    """Factorized `_enc_u8_packed`'s batched layout stage: [1 byte: the
    highest overflow level | int8 symbols], one buffer for one copy."""

    def forward(self, sym8, overflow):
        flag = overflow.amax().to(torch.uint8).reshape(1)
        return torch.cat([flag, _bytes(sym8)])


class _DecU8(nn.Module):
    """Factorized `_dec_u8`: integer symbols (B, M, h, w) channel-major ->
    uint8 pixels (B, H, W, C)."""

    def __init__(self, module, medians: np.ndarray):
        super().__init__()
        self.module = _only(module, "g_s")
        self.register_buffer("medians", _const(module, medians, 1, -1, 1, 1))

    def forward(self, sym):
        return _u8_pixels(self.module.g_s(_cl(sym.float() + self.medians)))


class _AnalyzeU8(nn.Module):
    """Hyperprior `_analyze_u8`'s per-image graph: pixels (1, H, W, C),
    uint8 (or float in [0, 1]) -> (y (1, M, H/16, W/16), int8 z symbols
    (1, N, h, w) channel-major, int32 (1,) overflow level of the z
    symbols). The AR codecs' `_analyze_u8_ar` too."""

    def __init__(self, module, z_medians: np.ndarray):
        super().__init__()
        self.module = _only(module, "g_a", "h_a")
        self.register_buffer("z_medians",
                             _const(module, z_medians, 1, -1, 1, 1))

    def forward(self, x):
        y, z = self.module.analyze(_pixels_in(x))
        z_sym = torch.round(z - self.z_medians)
        return y, z_sym.to(torch.int8).contiguous(), _overflow(z_sym)


class _ParamsFromZsym(nn.Module):
    """Hyperprior `_params_from_zsym`'s per-image graph: integer z symbols
    (1, N, h, w) channel-major -> (uint8 scale indexes (1, M, H, W)
    channel-major, means or None). The one place the entropy parameters
    are derived, on both sides of the wire."""

    gc = GaussianConditional()

    def __init__(self, module, z_medians: np.ndarray, scale_table):
        super().__init__()
        self.module = _only(module, "h_s")
        self.register_buffer("z_medians",
                             _const(module, z_medians, 1, -1, 1, 1))
        self.register_buffer("scale_table", _const(module, scale_table, -1))

    def forward(self, z_sym):
        z_hat = _cl(z_sym.float() + self.z_medians)
        scales, means = self.module.hyper_to_params(z_hat)
        idx = self.gc.build_indexes(self.scale_table, scales)
        return idx.to(torch.uint8).contiguous(), means


class _YSym(nn.Module):
    """Hyperprior `_ysym` (elementwise, batched): y and the means ->
    (int8 and int16 symbols channel-major, int32 (1,) overflow level)."""

    def forward(self, y, means=None):
        sym = torch.round(y - means if means is not None else y)
        return (sym.to(torch.int8).contiguous(),
                sym.to(torch.int16).contiguous(), _overflow(sym))


class _PackEnc(nn.Module):
    """Hyperprior `_pack_enc` (layout only, batched): [z level, y level |
    int8 z | uint8 indexes | int8 y], one buffer for one copy."""

    def forward(self, z8, idx, y8, zovf, yovf):
        flags = torch.stack([zovf.amax(), yovf.amax()]).to(torch.uint8)
        return torch.cat([flags, _bytes(z8), idx.reshape(-1), _bytes(y8)])


class _SynthU8(nn.Module):
    """Hyperprior `_synth_u8` (batched): integer y symbols (B, M, H, W)
    channel-major and the means (or float y_hat alone: the AR codecs'
    `_g_s_u8`) -> uint8 pixels (B, H, W, C)."""

    def __init__(self, module):
        super().__init__()
        self.module = _only(module, "g_s")

    def forward(self, y_sym, means=None):
        y_hat = y_sym.float()
        if means is not None:
            y_hat = y_hat + means
        return _u8_pixels(self.module.g_s(_cl(y_hat)))


def _gather(outs, device):
    """Per-item or per-block results (tensors, or tuples of tensors or
    None) concatenated along the batch, in order, on `device` (None:
    where they are)."""
    def cat(parts):
        return torch.cat([p if device is None else p.to(device)
                          for p in parts])

    if isinstance(outs[0], tuple):
        return tuple(None if o[0] is None else cat(o) for o in zip(*outs))
    return cat(outs)


class _PerItem:
    """Run a B = 1 device graph once per batch item and concatenate.

    The wire-determining graphs (the analysis transforms, the hyper
    synthesis that picks the scale buckets) must not see the batch shape:
    a batched conv may sum in another order than its B = 1 run, and a
    1-ulp scale difference flips a Gaussian bucket and desyncs the stream.
    `post`, when given, is a batched layout-only stage applied to the
    concatenated results. `inner` stays exposed for export (utils/aot.py
    exports it at B = 1 and re-wraps it on load).

    Multi-device serving (`parallel.shard_codec`) `place`s it on a mesh:
    items go round-robin over the mesh's devices, each through that
    device's copy of `inner` (the same graph and weights, so a
    homogeneous device set computes the same numbers), and the results
    concatenate on the first device."""

    def __init__(self, inner, post=None):
        self.inner = inner
        self.post = post
        self.devices = None
        self._replicas = None

    def place(self, devices, replicas):
        """Run item i on `devices[i % n]` through `replicas[i % n]`."""
        self.devices, self._replicas = list(devices), list(replicas)

    def __call__(self, *args):
        B = args[0].shape[0]
        devs = self.devices
        if B == 1 and not devs:
            out = self.inner(*args)
        else:
            outs = []
            for i in range(B):
                sl = [a[i:i + 1] for a in args]
                inner = self.inner
                if devs:
                    dev = devs[i % len(devs)]
                    sl = [a.to(dev) for a in sl]
                    inner = self._replicas[i % len(devs)]
                outs.append(inner(*sl))
            out = _gather(outs, devs[0] if devs else None)
        if self.post is None:
            return out
        return self.post(*out) if isinstance(out, tuple) else self.post(out)


class _Sharded:
    """A batch-safe graph (elementwise, or per-row like the synthesis)
    over a mesh: its batch splits into contiguous row blocks in order,
    one a device (`parallel.rank_rows`), each through that device's copy
    (`replicas`); the results concatenate on the first device. `None`
    arguments (the scale-only hyperprior's means) pass through."""

    def __init__(self, devices, replicas):
        self.devices, self.replicas = list(devices), list(replicas)

    @property
    def inner(self):
        """The graph of one block, on the first device (what a bundle
        exports)."""
        return self.replicas[0]

    def __call__(self, *args):
        from lmic_tpu_torch.parallel import rank_rows

        n = len(self.devices)
        outs = [rep(*(None if a is None else rank_rows(a, r, n).to(dev)
                      for a in args))
                for r, (dev, rep) in enumerate(zip(self.devices,
                                                   self.replicas))]
        return _gather(outs, self.devices[0])


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

    def _ensure(self, build: str):
        """Run the method `build` unless it ran for the current coding
        tables: the device functions it makes hold their medians and scale
        table, and the tables can be replaced (`update`, a deployment
        checkpoint, tables carried across)."""
        built = self.__dict__.get("_built_for", {})
        tables = built.get(build)
        if (tables is None or tables[0] is not self.eb_state
                or tables[1] is not self.gc_state):
            getattr(self, build)()
            # a new dict: a shallow copy of the codec (a fan-out view)
            # must not mark the original's functions as built
            self._built_for = {**built,
                               build: (self.eb_state, self.gc_state)}

    @staticmethod
    def _check_u8(x: np.ndarray, what: str):
        if x.dtype != np.uint8:
            raise ValueError(f"{what}: uint8 fast path only, got {x.dtype}")

    @property
    def _host_worker(self):
        """One worker thread for the host half of `decompress_async`: a
        pipelining caller then overlaps this batch's decode (host rANS and
        its copies) with the next batch's encode. rANS and kernel launches
        run in native code that releases the GIL."""
        pool = getattr(self, "_host_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = self._host_pool = ThreadPoolExecutor(max_workers=1)
        return pool

    @staticmethod
    def _decode_threaded() -> bool:
        """LMIC_DECODE_THREAD=1 moves decompress_async's host half to the
        worker thread (`_host_worker`); off by default, as in lmic_tpu.
        Inline, the pixels' copy still overlaps the caller's next batch."""
        return os.environ.get("LMIC_DECODE_THREAD", "0") == "1"

    def _decompress_async(self, body, strings, shape):
        """`body(strings, shape)` -> a finalizer, run inline or on the
        worker thread (`_decode_threaded`). Under the bf16 matmul
        precision it runs inline: the mode is the calling thread's, and
        its rounded ops switch TF32 for the whole process
        (`ops/precision.py`), under the feet of the caller's next
        encode."""
        if not self._decode_threaded() or precision.current() is not None:
            return body(strings, shape)
        fut = self._host_worker.submit(body, strings, shape)
        return lambda: fut.result()()


class _FanOut:
    """Multi-device serving of the codecs whose batch items are coded
    whole and independently (the AR images, the video sequences): each
    item runs on one device, round-robin, one worker thread a device
    (lmic_tpu's `fanout` and `_fanout_map`, models/joint.py:347-375, and
    video's `_chunk_map`, models/video.py:566-600). Every device runs the
    same per-item graphs on the same weights, so a homogeneous device set
    codes the bytes of one device."""

    _fanout_devices = None

    def fanout(self, devices):
        """Serve batches across `devices` (a homogeneous set; a device
        may stand in it more than once, a slot each). The weights are
        copied to each other device now (`parallel.replicate`)."""
        from lmic_tpu_torch.parallel import Mesh, replicate

        mesh = Mesh(devices)
        self._fanout_devices = mesh.devices
        self._fanout_modules = dict(zip(mesh.devices,
                                        replicate(mesh, self.module)))
        return self

    def _on(self, device):
        """This codec on `device`: itself where its weights live, else a
        shallow copy holding `fanout`'s copy of the weights and the same
        tables."""
        module = self._fanout_modules[device]
        if module is self.module:
            return self
        view = copy.copy(self)
        view.device, view.module = device, module
        view.__dict__.pop("_built_for", None)
        return view

    def _fanout_map(self, n_items: int, fn):
        """[fn(i, codec) for each item], `codec` this one on item i's
        device, device i mod n of the fan-out's n. The items of a device
        run in order on a worker thread of their own (kernel launches,
        copies and the host rANS release the GIL). Without a fan-out, for
        one item, or under the bf16 matmul precision (the mode is the
        calling thread's, and its rounded ops switch TF32 process-wide,
        `ops/precision.py`), the items run in order on the calling
        thread."""
        devs = self._fanout_devices
        if not devs:
            return [fn(i, self) for i in range(n_items)]
        n = min(len(devs), n_items)
        if n < 2 or precision.current() is not None:
            return [fn(i, self._on(devs[i % n])) for i in range(n_items)]
        out = [None] * n_items

        def slot(s):
            codec = self._on(devs[s])
            on_card = (torch.cuda.device(devs[s]) if devs[s].type == "cuda"
                       else contextlib.nullcontext())
            with on_card, torch.inference_mode():
                for i in range(s, n_items, n):
                    out[i] = fn(i, codec)

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=n) as pool:
            list(pool.map(slot, range(n)))
        return out


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

    def _build_u8_fns(self):
        """The uint8 fast path's device functions (lmic_tpu's names): the
        analysis per image, packed with its overflow flag into one buffer;
        the int16 escape; the synthesis to uint8 pixels."""
        med = self.eb_state.medians
        self._enc_u8_packed = _PerItem(_EncU8(self.module, med),
                                       post=_PackSymbols())
        self._enc_u8 = _PerItem(_EncU8(self.module, med, wide=True))
        self._dec_u8 = _DecU8(self.module, med)

    def _latent_shape(self, B, H, W):
        # stride-2 convs emit ceil(H/2) per stage: 4 stages -> ceil(H/16)
        return (B, self.module.M, -(-H // 16), -(-W // 16))

    @torch.inference_mode()
    def _fetch_symbols(self, x, x_dev, fetch):
        """One copy resolves flag and symbols; on an int8 overflow the
        int16 escape runs, past int16 the plain path (same bytes)."""
        t0 = time.perf_counter()
        buf = fetch.result()
        self._stat("enc_fetch_ms", t0)
        if buf[0] == 0:
            B, H, W = x_dev.shape[:3]
            return buf[1:].view(np.int8).reshape(self._latent_shape(B, H, W))
        if buf[0] == 1:
            return _Fetch(self._enc_u8(x_dev)).result()
        return self._plain_symbols(x.astype(np.float32) / 255.0)

    def _plain_symbols(self, x):
        """The plain path's symbols of float pixels, int32 on the host."""
        med = self._medians(self.eb_state)
        return np.concatenate([
            _symbols_to_host(torch.round(
                self.module.g_a(self._pixels(x[i:i + 1])) - med
            ))
            for i in range(x.shape[0])
        ])

    def _code_symbols(self, sym):
        t0 = time.perf_counter()
        B, C, h, w = sym.shape
        indexes = np.repeat(np.arange(C, dtype=np.int32), h * w)
        strings = rans.encode_batch(sym.reshape(B, -1), indexes,
                                    self.eb_state.table)
        self._stat("enc_rans_ms", t0)
        return {"strings": [strings], "shape": (h, w)}

    @torch.inference_mode()
    def compress_async(self, x):
        """Dispatch the device half of compress (uint8 only) and start its
        copy to the host; the finalizer waits for the copy and runs the
        host coder, so a caller codes this batch while the device runs the
        next."""
        self._check_updated()
        x = np.asarray(x)
        self._check_u8(x, "compress_async")
        self._ensure("_build_u8_fns")
        set_wire_determinism()
        x_dev = _to_device(x, self.device)
        fetch = _Fetch(self._enc_u8_packed(x_dev))
        return lambda: self._code_symbols(self._fetch_symbols(x, x_dev,
                                                              fetch))

    @torch.inference_mode()
    def compress(self, x):
        """x: (B, H, W, C) float in [0, 1] or uint8 (the fast path)."""
        self._check_updated()
        x = np.asarray(x)
        if x.dtype == np.uint8:
            return self.compress_async(x)()
        set_wire_determinism()
        t0 = time.perf_counter()
        sym = self._plain_symbols(x)
        self._stat("enc_device_ms", t0)
        return self._code_symbols(sym)

    @staticmethod
    def _check_strings(strings):
        if not isinstance(strings, list) or len(strings) != 1:
            raise ValueError("factorized streams have one string group")

    @torch.inference_mode()
    def _decompress_u8_body(self, strings, shape):
        """Host rANS, the symbols' upload, the synthesis dispatched and its
        pixels' copy started: returns the finalizer."""
        set_wire_determinism()
        t0 = time.perf_counter()
        sym = self.eb_state.decode_symbols(strings[0], tuple(shape))
        self._stat("dec_rans_ms", t0)
        fetch = _Fetch(self._dec_u8(_to_device(
            sym.astype(_narrowest_int(sym)), self.device)))

        def finalize():
            t1 = time.perf_counter()
            out = fetch.result()
            self._stat("dec_fetch_ms", t1)
            return {"x_hat": out}

        return finalize

    def decompress_async(self, strings, shape):
        """Run the host half of decode (inline, or on the worker thread
        with LMIC_DECODE_THREAD=1) and return a finalizer giving the uint8
        pixels, whose copy runs in the background."""
        self._check_updated()
        self._check_strings(strings)
        self._ensure("_build_u8_fns")
        return self._decompress_async(self._decompress_u8_body, strings,
                                      shape)

    @torch.inference_mode()
    def decompress(self, strings, shape, u8: bool = False):
        self._check_updated()
        self._check_strings(strings)
        if u8:
            self._ensure("_build_u8_fns")
            return self._decompress_u8_body(strings, shape)()
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

    def _build_u8_fns(self):
        """The uint8 fast path's device functions (lmic_tpu's names). The
        analysis and the params graph are wire-determining and run per
        image (`_PerItem`); the y symbols, the pack and the synthesis are
        elementwise or layout-only, or reach no wire, and run batched."""
        z_med = self.eb_state.medians
        self._analyze_u8 = _PerItem(_AnalyzeU8(self.module, z_med))
        self._params_from_zsym = _PerItem(_ParamsFromZsym(
            self.module, z_med, self.gc_state.scale_table))
        self._ysym = _YSym()
        self._pack_enc = _PackEnc()
        self._synth_u8 = _SynthU8(self.module)

    def _params_for_wire_z(self, z_sym: np.ndarray):
        """Entropy parameters of the WIRE z symbols (int32, channel-major
        (B, C, h, w)): they cross in their narrowest integer type and go
        through `_params_from_zsym`, the graph that every path runs.
        Returns (indexes int32 (B, M, H, W) on the host, means on the
        device or None)."""
        self._ensure("_build_u8_fns")
        z_dev = _to_device(z_sym.astype(_narrowest_int(z_sym)), self.device)
        idx, means = self._params_from_zsym(z_dev)
        return idx.cpu().numpy().astype(np.int32), means

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

    def _latent_shapes(self, B, H, W):
        # ceil division: the conv stacks emit ceil(H/2) per stride-2 stage
        m = self.module
        return ((B, m.N, -(-H // 64), -(-W // 64)),
                (B, m.M, -(-H // 16), -(-W // 16)))

    @torch.inference_mode()
    def compress_async(self, x):
        """Dispatch the whole device half of compress (uint8 only): the
        analysis and the params graph per image, the y symbols, and the
        pack; start the packed buffer's copy to the host. The finalizer
        waits for that copy and runs the host coder."""
        self._check_updated()
        x = np.asarray(x)
        self._check_dims(x)
        self._check_u8(x, "compress_async")
        self._ensure("_build_u8_fns")
        set_wire_determinism()
        x_dev = _to_device(x, self.device)
        y, z8, zovf = self._analyze_u8(x_dev)
        idx, means = self._params_from_zsym(z8)
        y8, y16, yovf = self._ysym(y, means)
        fetch = _Fetch(self._pack_enc(z8, idx, y8, zovf, yovf))
        return lambda: self._finish_compress_u8(x, fetch, y16)

    def _finish_compress_u8(self, x: np.ndarray, fetch, y16):
        t0 = time.perf_counter()
        buf = fetch.result()
        t0 = self._stat("enc_fetch_ms", t0)
        if buf[0] or buf[1] > 1:
            # a z symbol outside int8 or a y symbol past int16: the plain
            # path, same bytes
            return self.compress(x.astype(np.float32) / 255.0)
        zshape, yshape = self._latent_shapes(*x.shape[:3])
        zn, yn = int(np.prod(zshape)), int(np.prod(yshape))
        if buf.size != 2 + zn + 2 * yn:
            raise ValueError("packed encode layout mismatch")
        z_sym = buf[2:2 + zn].view(np.int8).reshape(zshape)
        idx = buf[2 + zn:2 + zn + yn].reshape(yshape)
        if buf[1]:  # a y symbol outside int8: the int16 copy
            y_sym = _Fetch(y16).result()
        else:
            y_sym = buf[2 + zn + yn:].view(np.int8).reshape(yshape)
        B = zshape[0]
        z_strings = self._encode_z(z_sym)
        y_strings = rans.encode_batch(y_sym.reshape(B, -1),
                                      idx.reshape(B, -1), self.gc_state.table)
        self._stat("enc_rans_ms", t0)
        return {"strings": [y_strings, z_strings], "shape": zshape[2:4]}

    @torch.inference_mode()
    def compress(self, x):
        """x: (B, H, W, C) float in [0, 1] or uint8 (the fast path); H, W
        multiples of 64."""
        self._check_updated()
        x = np.asarray(x)
        self._check_dims(x)
        if x.dtype == np.uint8:
            return self.compress_async(x)()
        set_wire_determinism()
        t0 = time.perf_counter()
        ys, z_sym = self._analyze(x)
        idx, means = self._params_for_wire_z(z_sym)
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

    @staticmethod
    def _check_strings(strings):
        if not isinstance(strings, list) or len(strings) != 2:
            raise ValueError("hyperprior streams have two string groups")

    @torch.inference_mode()
    def _decompress_u8(self, strings, shape):
        """The uint8 decode: host rANS of z, the params graph, the indexes'
        copy, host rANS of y, the synthesis dispatched and its pixels'
        copy started. Returns the finalizer."""
        set_wire_determinism()
        y_strings, z_strings = strings
        t0 = time.perf_counter()
        z_sym = self.eb_state.decode_symbols(z_strings, tuple(shape))
        t0 = self._stat("dec_z_rans_ms", t0)
        if _narrowest_int(z_sym) is not np.int8:
            # z outside int8: the plain path (which a frozen bundle lacks)
            out = self.decompress(strings, shape)
            x_hat = np.round(out["x_hat"] * 255.0).astype(np.uint8)
            return lambda: {"x_hat": x_hat}
        idx, means = self._params_from_zsym(
            _to_device(z_sym.astype(np.int8), self.device))
        idx = _Fetch(idx).result().astype(np.int32)
        t0 = self._stat("dec_idx_fetch_ms", t0)
        B = idx.shape[0]
        y_sym = rans.decode_batch(y_strings, idx.reshape(B, -1),
                                  self.gc_state.table).reshape(idx.shape)
        self._stat("dec_y_rans_ms", t0)
        fetch = _Fetch(self._synth_u8(_to_device(
            y_sym.astype(_narrowest_int(y_sym)), self.device), means))

        def finalize():
            t1 = time.perf_counter()
            out = fetch.result()
            self._stat("dec_fetch_ms", t1)
            return {"x_hat": out}

        return finalize

    def decompress_async(self, strings, shape):
        """Run the host half of decode (inline, or on the worker thread
        with LMIC_DECODE_THREAD=1) and return a finalizer giving the uint8
        pixels, whose copy runs in the background."""
        self._check_updated()
        self._check_strings(strings)
        self._ensure("_build_u8_fns")
        return self._decompress_async(self._decompress_u8, strings, shape)

    @torch.inference_mode()
    def decompress(self, strings, shape, u8: bool = False):
        self._check_updated()
        self._check_strings(strings)
        if u8:
            self._ensure("_build_u8_fns")
            return self._decompress_u8(strings, shape)()
        set_wire_determinism()
        y_strings, z_strings = strings
        t0 = time.perf_counter()
        z_sym = self.eb_state.decode_symbols(z_strings, tuple(shape))
        t0 = self._stat("dec_z_rans_ms", t0)
        idx, means = self._params_for_wire_z(z_sym)
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
