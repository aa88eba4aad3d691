"""ctypes bindings for the port's copy of the native rANS coder
(lmic_tpu_torch/csrc/lmic_rans.cc, the same stream format as lmic_tpu's).

The library is built with g++ into lmic_tpu_torch/_build/ on first use
(ops/_build.py); it never shares an artifact with the JAX package. The C
ABI keeps the boundary to raw int32/uint8 pointers and numpy arrays, with
no per-symbol Python objects.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from lmic_tpu_torch.ops import _build

_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_LOCK = threading.Lock()
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = _build.load("lmic_rans.cc")
        lib.lmic_rans_encode_with_indexes.restype = ctypes.c_int64
        lib.lmic_rans_encode_with_indexes.argtypes = [
            _i32p, _i32p, ctypes.c_int64, _i32p, ctypes.c_int64, _i32p, _i32p,
            _u8p, ctypes.c_int64,
        ]
        lib.lmic_rans_encoder_new.restype = ctypes.c_void_p
        lib.lmic_rans_encoder_new.argtypes = []
        lib.lmic_rans_encoder_append.restype = None
        lib.lmic_rans_encoder_append.argtypes = [
            ctypes.c_void_p, _i32p, _i32p, ctypes.c_int64, _i32p,
            ctypes.c_int64, _i32p, _i32p,
        ]
        lib.lmic_rans_encoder_flush.restype = ctypes.c_int64
        lib.lmic_rans_encoder_flush.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_int64,
        ]
        lib.lmic_rans_encoder_free.argtypes = [ctypes.c_void_p]
        lib.lmic_rans_decoder_new.restype = ctypes.c_void_p
        lib.lmic_rans_decoder_new.argtypes = [_u8p, ctypes.c_int64]
        lib.lmic_rans_decoder_free.argtypes = [ctypes.c_void_p]
        lib.lmic_rans_build_lut.argtypes = [
            _i32p, ctypes.c_int64, _i32p, ctypes.c_int64, _u16p,
        ]
        lib.lmic_rans_decode_with_indexes_lut.restype = ctypes.c_int64
        lib.lmic_rans_decode_with_indexes_lut.argtypes = [
            _u8p, ctypes.c_int64, _i32p, ctypes.c_int64, _i32p,
            ctypes.c_int64, _i32p, _i32p, _u16p, _i32p,
        ]
        lib.lmic_rans_decoder_decode_lut.restype = ctypes.c_int64
        lib.lmic_rans_decoder_decode_lut.argtypes = [
            ctypes.c_void_p, _i32p, ctypes.c_int64, _i32p, ctypes.c_int64,
            _i32p, _i32p, _u16p, _i32p,
        ]
        _lib = lib
    return _lib


def _as_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), dtype=np.int32)


def _i32_ptr(a: np.ndarray):
    return a.ctypes.data_as(_i32p)


class CdfTable:
    """Frozen integer CDF tables for one entropy model.

    `cdf` is `(rows, max_len)` int32 with each row a monotone CDF padded with
    zeros; `cdf_length[i]` is the valid row length; `offset[i]` shifts symbol
    values into table range. Mirrors the `_quantized_cdf/_cdf_length/_offset`
    buffers of the reference (entropy_models.py:129-131).
    """

    __slots__ = ("cdf", "cdf_length", "offset", "_lut")

    _LUT_SPAN = 1 << 8  # coarse buckets of cum >> 8; see lmic_rans.cc

    def __init__(self, cdf, cdf_length, offset):
        self.cdf = _as_i32(cdf).reshape(np.asarray(cdf).shape)
        if self.cdf.ndim != 2:
            raise ValueError("cdf must be 2-D")
        self.cdf_length = _as_i32(cdf_length)
        self.offset = _as_i32(offset)
        if not (len(self.cdf) == len(self.cdf_length) == len(self.offset)):
            raise ValueError("cdf/cdf_length/offset row mismatch")
        self._lut = None

    @property
    def stride(self) -> int:
        return self.cdf.shape[1]

    def lut(self) -> np.ndarray:
        """Lazy coarse cum->slot table (256 uint16 buckets per row): gives
        the decoder a near-exact starting slot, so the per-symbol search is
        a 1-2 step forward scan instead of a binary search."""
        if self._lut is None:
            rows = self.cdf.shape[0]
            lut = np.empty((rows, self._LUT_SPAN), dtype=np.uint16)
            _load().lmic_rans_build_lut(
                _i32_ptr(self.cdf.reshape(-1)), self.stride,
                _i32_ptr(self.cdf_length), rows, lut.ctypes.data_as(_u16p),
            )
            self._lut = lut
        return self._lut


def encode_with_indexes(symbols, indexes, table: CdfTable) -> bytes:
    """Encode int32 symbols (flattened) against per-symbol CDF rows."""
    lib = _load()
    symbols = _as_i32(symbols)
    indexes = _as_i32(indexes)
    if symbols.shape != indexes.shape:
        raise ValueError("symbols and indexes must have the same size")
    n = symbols.size
    out = np.empty(n * 48 + 16, dtype=np.uint8)
    nbytes = lib.lmic_rans_encode_with_indexes(
        _i32_ptr(symbols), _i32_ptr(indexes), n,
        _i32_ptr(table.cdf), table.stride,
        _i32_ptr(table.cdf_length), _i32_ptr(table.offset),
        out.ctypes.data_as(_u8p), out.size,
    )
    if nbytes < 0:
        raise RuntimeError("rANS encode buffer overflow")
    return out[:nbytes].tobytes()


def decode_with_indexes(stream: bytes, indexes, table: CdfTable) -> np.ndarray:
    """Decode `len(indexes)` int32 symbols from a byte stream."""
    lib = _load()
    indexes = _as_i32(indexes)
    n = indexes.size
    out = np.empty(n, dtype=np.int32)
    buf = np.frombuffer(stream, dtype=np.uint8)
    lib.lmic_rans_decode_with_indexes_lut(
        buf.ctypes.data_as(_u8p), buf.size, _i32_ptr(indexes), n,
        _i32_ptr(table.cdf), table.stride,
        _i32_ptr(table.cdf_length), _i32_ptr(table.offset),
        table.lut().ctypes.data_as(_u16p), out.ctypes.data_as(_i32p),
    )
    return out


class BufferedRansEncoder:
    """Chunked encoder: append symbol chunks in forward order, then
    `flush()` the whole stream (emitted in reverse, as rANS requires).
    Counterpart of lmic_tpu/entropy/coder.py:200."""

    def __init__(self):
        self._lib = _load()
        self._handle = self._lib.lmic_rans_encoder_new()
        self._n = 0

    def encode_with_indexes(self, symbols, indexes, table: CdfTable):
        symbols = _as_i32(symbols)
        indexes = _as_i32(indexes)
        if symbols.shape != indexes.shape:
            raise ValueError("symbols and indexes must have the same size")
        self._n += symbols.size
        self._lib.lmic_rans_encoder_append(
            self._handle, _i32_ptr(symbols), _i32_ptr(indexes), symbols.size,
            _i32_ptr(table.cdf), table.stride,
            _i32_ptr(table.cdf_length), _i32_ptr(table.offset),
        )

    def flush(self) -> bytes:
        out = np.empty(self._n * 48 + 16, dtype=np.uint8)
        nbytes = self._lib.lmic_rans_encoder_flush(
            self._handle, out.ctypes.data_as(_u8p), out.size
        )
        if nbytes < 0:
            raise RuntimeError("rANS encode buffer overflow")
        self._n = 0
        return out[:nbytes].tobytes()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.lmic_rans_encoder_free(self._handle)
            self._handle = None


class RansDecoder:
    """Streaming decoder: decode a stream in consecutive chunks."""

    def __init__(self):
        self._lib = _load()
        self._handle = None

    def set_stream(self, stream: bytes):
        if self._handle:
            self._lib.lmic_rans_decoder_free(self._handle)
        buf = np.frombuffer(stream, dtype=np.uint8)  # the decoder copies it
        self._handle = self._lib.lmic_rans_decoder_new(
            buf.ctypes.data_as(_u8p), buf.size
        )

    def decode_stream(self, indexes, table: CdfTable) -> np.ndarray:
        if not self._handle:
            raise RuntimeError("set_stream() first")
        indexes = _as_i32(indexes)
        out = np.empty(indexes.size, dtype=np.int32)
        self._lib.lmic_rans_decoder_decode_lut(
            self._handle, _i32_ptr(indexes), indexes.size,
            _i32_ptr(table.cdf), table.stride,
            _i32_ptr(table.cdf_length), _i32_ptr(table.offset),
            table.lut().ctypes.data_as(_u16p), out.ctypes.data_as(_i32p),
        )
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.lmic_rans_decoder_free(self._handle)
            self._handle = None


# ---------------------------------------------------------------------------
# Threaded batch API: ctypes calls release the GIL, so the independent
# images of a batch are coded in parallel on the host cores.
# ---------------------------------------------------------------------------

_POOL = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(
                max_workers=min(16, os.cpu_count() or 1),
                thread_name_prefix="lmic-rans",
            )
    return _POOL


def _map(fn, n: int):
    if n == 1 or (os.cpu_count() or 1) <= 1:
        return [fn(i) for i in range(n)]
    return list(_pool().map(fn, range(n)))


def encode_batch(symbols, indexes, table: CdfTable):
    """Encode a batch: symbols (B, ...) int array -> list of B byte strings.
    `indexes` either has the same leading batch dim or is shared across the
    batch (one fewer dim)."""
    symbols = np.asarray(symbols)
    indexes = np.asarray(indexes)
    B = symbols.shape[0]
    sym = np.ascontiguousarray(symbols.reshape(B, -1), dtype=np.int32)
    if indexes.ndim < symbols.ndim:
        idx = [_as_i32(indexes)] * B
    else:
        idx = np.ascontiguousarray(indexes.reshape(B, -1), dtype=np.int32)
    return _map(lambda i: encode_with_indexes(sym[i], idx[i], table), B)


def decode_batch(streams, indexes, table: CdfTable) -> np.ndarray:
    """Decode a batch of independent streams against shared (1-D) or
    per-item (2-D) indexes. Returns (B, n) int32."""
    idx = np.ascontiguousarray(np.asarray(indexes), dtype=np.int32)
    per_item = idx.ndim == 2
    return np.stack(_map(
        lambda i: decode_with_indexes(
            streams[i], idx[i] if per_item else idx, table
        ),
        len(streams),
    ))
