"""GDN/IGDN forward and backward: the CUDA kernels and their plain versions.

Counterpart of lmic_tpu/ops/pallas_gdn.py (`gdn_core` with its custom VJP,
`_gdn_jnp`, `_kernel`, `_gdn_bwd_jnp`, `_bwd_kernel`).
`gdn_core(x, beta, gamma, inverse)` takes POST-reparametrization beta/gamma
and channel-last activations `(..., C)`:

- a CUDA tensor goes to the hand-written kernels: `gdn_fwd`
  (csrc/gdn_fwd.cu) forward and `gdn_bwd` (csrc/gdn_bwd.cu) backward, f32
  on the FP32 cores and bf16 (AMP) on the tensor cores, at every C that
  lmic_tpu's `gdn_core` takes; they never fall back to the plain
  versions, and a failed launch raises;
- a CPU tensor, and a CUDA tensor of a dtype the kernels do not take (f16,
  f64: lmic_tpu's `_gdn_jnp` path), goes to `gdn_reference` /
  `gdn_bwd_reference`, the same formulas in plain torch.

The forward is reached through the operator `lmic_tpu_torch::gdn_fwd`
(`gdn_fwd_op`, a `torch.library.custom_op` with both implementations and
a fake one for tracing), so `torch.export` keeps it as one node
(utils/aot.py).

When a gradient is wanted, `gdn_core` runs `GDNCore`, the
`torch.autograd.Function` counterpart of `gdn_core.defvjp(_gdn_fwd,
_gdn_bwd)`: the forward saves `(x, beta, gamma)` and nothing else, and the
backward recomputes the norm. Under `torch.no_grad()`/`inference_mode()`
the forward runs alone, with no autograd bookkeeping.
"""

from __future__ import annotations

import ctypes
import threading

import torch
from torch.autograd.function import once_differentiable

from lmic_tpu_torch.ops import _build

# Launches of each kernel of this module, counted where the wrapper launches
# it and nowhere else; a caller resets and reads it to show which path ran.
# `gdn_bwd` launches three kernels, each counted under its own name.
LAUNCHES = {"gdn_fwd": 0, "gdn_bwd_dx": 0, "gdn_bwd_partials": 0,
            "gdn_bwd_reduce": 0}
BWD_KERNELS = ("gdn_bwd_dx", "gdn_bwd_partials", "gdn_bwd_reduce")

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOCK = threading.Lock()
# the launches of a codec's decode thread (LMIC_DECODE_THREAD=1) and of
# the caller's thread are counted in one dict
_COUNT_LOCK = threading.Lock()


def _count(kernel: str):
    with _COUNT_LOCK:
        LAUNCHES[kernel] += 1
_libs = {}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "gdn_fwd.cu": {
        "lmic_gdn_fwd": [_P, _P, _P, _P, _I64, _I, _I, _I, _P, _P],
        "lmic_gdn_fwd_scratch_bytes": [_P, _P, _P, _I64, _I, _I],
        "lmic_gdn_fwd_kernel_name": [_I],
        "lmic_gdn_fwd_kernel_launches": [_I],
        "lmic_gdn_error_string": [_I],
    },
    "gdn_bwd.cu": {
        "lmic_gdn_bwd_dx": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I, _I,
                            _I, _P, _P],
        "lmic_gdn_bwd_partials": [_P, _P, _P, _P, _I64, _I, _I, _P],
        "lmic_gdn_bwd_reduce": [_P, _P, _P, _I64, _I, _I, _P],
        "lmic_gdn_bwd_chunk_rows": [],
        "lmic_gdn_bwd_tile_rows": [],
        "lmic_gdn_bwd_dx_scratch_bytes": [_P, _P, _P, _P, _P, _I64, _I, _I],
        "lmic_gdn_bwd_kernel_name": [_I],
        "lmic_gdn_bwd_kernel_launches": [_I],
        "lmic_gdn_bwd_error_string": [_I],
    },
}


def _restype(name: str):
    """The ctypes return type of the C ABI entry point `name`."""
    if name.endswith(("_string", "_name")):
        return ctypes.c_char_p
    if name.endswith(("_launches", "_bytes")):
        return ctypes.c_int64
    return ctypes.c_int


def _load(source: str):
    with _LOCK:
        lib = _libs.get(source)
        if lib is None:
            lib = _build.load(source)
            for name, argtypes in _SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _restype(name)
            _libs[source] = lib
    return lib


def kernel_launches() -> dict:
    """{CUDA kernel name: launches so far} of each GDN library loaded in
    this process, counted by the C ABI where each launch succeeded (see
    `lmic_gdn_fwd_kernel_launches`): the difference around a run names the
    kernels its launches took. A library not loaded yet has launched
    nothing and is left out."""
    out = {}
    for source, prefix in (("gdn_fwd.cu", "lmic_gdn_fwd"),
                           ("gdn_bwd.cu", "lmic_gdn_bwd")):
        lib = _libs.get(source)
        name_of = getattr(lib, prefix + "_kernel_name", None)
        if name_of is None:
            continue
        k = 0
        while (name := name_of(k)) is not None:
            out[name.decode()] = getattr(lib, prefix + "_kernel_launches")(k)
            k += 1
    return out


def _acc(x):
    """Accumulation dtype: f32 for f32/bf16 activations, f64 for f64."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def gdn_reference(x, beta, gamma, inverse: bool = False):
    """y_i = x_i * (beta_i + sum_j gamma_ij x_j^2)^(-1/2 or +1/2), plain torch.

    Mirrors `_gdn_jnp`: x^2 in the input dtype, the channel product and the
    norm in f32 (f64 for f64 inputs), the scale cast back to the input dtype
    before the multiply. x: (..., C); beta: (C,); gamma: (C_out, C_in).
    """
    acc = _acc(x)
    norm = torch.matmul((x * x).to(acc), gamma.to(acc).t()) + beta.to(acc)
    scale = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return x * scale.to(x.dtype)


def gdn_bwd_reference(x, beta, gamma, g, inverse: bool = False):
    """(dx, dbeta, dgamma) of `gdn_reference` for the cotangent `g`, plain
    torch.

    Mirrors `_gdn_bwd_jnp`: the norm and dn accumulate in f32 (f64 for f64
    inputs); dn is cast to the input dtype before the two channel products;
    dx comes back in x's dtype, dbeta/dgamma in beta's/gamma's.
    """
    acc = _acc(x)
    C = x.shape[-1]
    x2 = x * x
    norm = torch.matmul(x2.to(acc), gamma.to(acc).t()) + beta.to(acc)
    g32, x32 = g.to(acc), x.to(acc)
    if inverse:  # y = x n^(1/2): dL/dn = g x n^(-1/2) / 2
        dn = 0.5 * g32 * x32 * torch.rsqrt(norm)
        scale = torch.sqrt(norm)
    else:  # y = x n^(-1/2): dL/dn = -g x n^(-3/2) / 2
        dn = -0.5 * g32 * x32 * norm ** -1.5
        scale = torch.rsqrt(norm)
    dnx = dn.to(x.dtype).to(acc)
    dx = g32 * scale + 2.0 * x32 * torch.matmul(dnx, gamma.to(acc))
    dbeta = dn.reshape(-1, C).sum(0)
    dgamma = torch.matmul(dnx.reshape(-1, C).t(), x2.reshape(-1, C).to(acc))
    return dx.to(x.dtype), dbeta.to(beta.dtype), dgamma.to(gamma.dtype)


def _check(fn, x, beta, gamma):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} takes float32 or bfloat16, got {x.dtype}")
    C = x.shape[-1]
    if tuple(beta.shape) != (C,) or tuple(gamma.shape) != (C, C):
        raise ValueError(
            f"{fn}: beta {tuple(beta.shape)} / gamma "
            f"{tuple(gamma.shape)} do not fit {C} channels"
        )
    for name, t in (("beta", beta), ("gamma", gamma)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"{fn}: {name} is {t.dtype} on {t.device}, x is "
                f"{x.dtype} on {x.device}"
            )
    return C


def _raise_on(err, lib, what):
    if err:
        raise RuntimeError(
            f"{what} launch failed: "
            f"{lib.lmic_gdn_bwd_error_string(err).decode()}"
        )


def gdn_fwd(x, beta, gamma, inverse: bool = False):
    """Launch the forward kernel on CUDA tensors x (..., C), beta (C,) and
    gamma (C, C) of one dtype, float32 or bfloat16, at any C. The C ABI
    picks the kernel by shape: f32 at C <= 384 runs `gdn_fwd_kernel`, wider
    f32 `gdn_fwd_f32_blocked_kernel` (on zero-padded copies in a scratch
    buffer allocated here where C % 4 != 0 or a base is off 16 bytes);
    bf16 at C = 128 and 192 with 16-byte aligned x, gamma and y runs
    `gdn_fwd_wide_kernel`, other bf16 shapes `gdn_fwd_stream_kernel` (on
    zero-padded copies where C % 8 != 0 or a base is off 16 bytes); a
    failed launch or tensor-map encode raises."""
    C = _check("gdn_fwd", x, beta, gamma)
    lib = _load("gdn_fwd.cu")
    if not x.is_contiguous():
        x = x.contiguous()  # explicit copy: the kernel reads (n, C) rows
    # the f32 kernel reads gamma^T, the bf16 kernel gamma's rows
    w = (gamma.t() if x.dtype == torch.float32 else gamma).contiguous()
    beta = beta.contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = x.numel() // C if C else 0
    if n == 0:
        return y
    code = _DTYPE_CODES[x.dtype]
    # the TMA's copies of operands it cannot address (C % 8 for bf16,
    # C % 4 for f32 past 384 channels, bases)
    nbytes = lib.lmic_gdn_fwd_scratch_bytes(x.data_ptr(), w.data_ptr(),
                                            y.data_ptr(), n, C, code)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
               if nbytes else None)
    with torch.cuda.device(x.device):
        err = lib.lmic_gdn_fwd(
            x.data_ptr(), w.data_ptr(), beta.data_ptr(), y.data_ptr(),
            n, C, code, int(bool(inverse)),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"gdn_fwd launch failed: {lib.lmic_gdn_error_string(err).decode()}"
        )
    _count("gdn_fwd")
    return y


def _dn_scratch(lib, n, C, dtype, device):
    """The buffers `gdn_bwd_dx` writes and `gdn_bwd_partials` reads: the
    (n, C) dn scratch, f32 for f32 inputs and bf16 for bf16 ones, and for
    bf16 the (ceil(n / tile rows), C) f32 tile sums of dn (empty for f32,
    whose kernels sum the f32 scratch)."""
    if dtype == torch.float32:
        return (torch.empty((n, C), dtype=torch.float32, device=device),
                torch.empty(0, dtype=torch.float32, device=device))
    tiles = -(-n // lib.lmic_gdn_bwd_tile_rows())
    return (torch.empty((n, C), dtype=dtype, device=device),
            torch.empty((tiles, C), dtype=torch.float32, device=device))


def gdn_bwd(x, beta, gamma, g, inverse: bool = False):
    """Launch the backward kernels on CUDA tensors: x and the cotangent g
    (..., C), beta (C,), gamma (C, C), all of one dtype, float32 or
    bfloat16. Returns (dx, dbeta, dgamma) in that dtype.

    Three launches, each counted, at any C: `gdn_bwd_dx` (dx and the dn
    scratch: f32 for f32; for bf16, dn rounded to bf16 and each 64-row
    tile's f32 sum of dn), `gdn_bwd_partials` (per-chunk partial
    dbeta/dgamma) and `gdn_bwd_reduce` (the fixed-order sum of the
    partials). The C ABI picks the dx kernel by shape: f32
    `gdn_bwd_dx_kernel` at C <= 384, `gdn_bwd_dx_f32_blocked_kernel` past
    it (both read gamma^T, built here; the blocked one on zero-padded
    copies in a scratch buffer allocated here where C % 4 != 0 or a base
    is off 16 bytes); bf16 at C = 128 and 192 with
    16-byte aligned operands `gdn_bwd_dx_wide_kernel`, other bf16 shapes
    `gdn_bwd_dx_stream_kernel` (on a scratch buffer allocated here: its
    g*scale workspace, and zero-padded copies where C % 8 != 0 or a base
    is off 16 bytes); a failed launch or tensor-map encode raises."""
    C = _check("gdn_bwd", x, beta, gamma)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(
            f"gdn_bwd: cotangent {tuple(g.shape)} {g.dtype} on {g.device} "
            f"does not match x {tuple(x.shape)} {x.dtype} on {x.device}"
        )
    lib = _load("gdn_bwd.cu")
    # the kernels read (n, C) rows; a cotangent that comes back from cuDNN
    # NCHW-contiguous is copied explicitly, never reinterpreted
    if not x.is_contiguous():
        x = x.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    gamma = gamma.contiguous()
    beta = beta.contiguous()
    dev, dt = x.device, x.dtype
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dbeta = torch.empty(C, dtype=dt, device=dev)
    dgamma = torch.empty((C, C), dtype=dt, device=dev)
    n = x.numel() // C if C else 0
    chunks = -(-n // lib.lmic_gdn_bwd_chunk_rows())
    dn, dn_sums = _dn_scratch(lib, n, C, dt, dev)
    code, inv = _DTYPE_CODES[dt], int(bool(inverse))
    # only the f32 dx kernels read gamma^T
    gamma_t = gamma.t().contiguous() if dt == torch.float32 else gamma
    partials = torch.empty((chunks, C * C + C), dtype=torch.float32,
                           device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if n:
            nbytes = lib.lmic_gdn_bwd_dx_scratch_bytes(
                x.data_ptr(), g.data_ptr(), gamma.data_ptr(), dx.data_ptr(),
                dn.data_ptr(), n, C, code)
            if nbytes < 0:
                raise RuntimeError("gdn_bwd_dx: the CUDA runtime gives no "
                                   "SM count for the device")
            scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
                       if nbytes else None)
            _raise_on(lib.lmic_gdn_bwd_dx(
                x.data_ptr(), g.data_ptr(), gamma_t.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), dx.data_ptr(),
                dn.data_ptr(), dn_sums.data_ptr(), n, C, code, inv,
                None if scratch is None else scratch.data_ptr(), stream,
            ), lib, "gdn_bwd_dx")
            _count("gdn_bwd_dx")
            _raise_on(lib.lmic_gdn_bwd_partials(
                x.data_ptr(), dn.data_ptr(), dn_sums.data_ptr(),
                partials.data_ptr(), n, C, code, stream,
            ), lib, "gdn_bwd_partials")
            _count("gdn_bwd_partials")
        # with no rows there are no partials, and the sum writes zeros
        _raise_on(lib.lmic_gdn_bwd_reduce(
            partials.data_ptr(), dbeta.data_ptr(), dgamma.data_ptr(),
            chunks, C, code, stream,
        ), lib, "gdn_bwd_reduce")
        _count("gdn_bwd_reduce")
    return dx, dbeta, dgamma


@torch.library.custom_op("lmic_tpu_torch::gdn_fwd", mutates_args=(),
                         device_types="cpu")
def gdn_fwd_op(x: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor,
               inverse: bool) -> torch.Tensor:
    """The GDN/IGDN forward as one operator, `torch.ops.lmic_tpu_torch.
    gdn_fwd`: the kernel for CUDA tensors (`gdn_fwd`, counted in
    `LAUNCHES`), `gdn_reference` for CPU tensors, and no other device.
    Being an operator, it stays one node in a `torch.export` graph (the
    kernel's ctypes launch reads data pointers, which tracing has not), so
    an exported codec runs the kernel, not an inlined plain version."""
    return gdn_reference(x, beta, gamma, inverse)


@gdn_fwd_op.register_kernel("cuda")
def _gdn_fwd_cuda(x, beta, gamma, inverse):
    return gdn_fwd(x, beta, gamma, inverse)


@gdn_fwd_op.register_fake
def _gdn_fwd_fake(x, beta, gamma, inverse):
    return torch.empty_like(x, memory_format=torch.contiguous_format)


def _plain_dtype(x):
    """A dtype the kernels do not take (f16, f64, ...): lmic_tpu's
    `gdn_core` sends it to `_gdn_jnp`, the port to the plain versions on
    the tensor's own device. Decided by dtype alone, before any launch."""
    return x.dtype not in _DTYPE_CODES


def _forward(x, beta, gamma, inverse):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"gdn_core: no GDN path for device {x.device}")
    if _plain_dtype(x):
        return gdn_reference(x, beta, gamma, bool(inverse))
    return gdn_fwd_op(x, beta, gamma, bool(inverse))


class GDNCore(torch.autograd.Function):
    """GDN/IGDN with the fused backward: the counterpart of lmic_tpu's
    `gdn_core` custom VJP. Saves `(x, beta, gamma)`, the JAX residuals."""

    @staticmethod
    def forward(ctx, x, beta, gamma, inverse):
        ctx.inverse = bool(inverse)
        ctx.save_for_backward(x, beta, gamma)
        return _forward(x, beta, gamma, inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, beta, gamma = ctx.saved_tensors
        if x.device.type == "cuda" and not _plain_dtype(x):
            dx, dbeta, dgamma = gdn_bwd(x, beta, gamma, g, ctx.inverse)
        else:
            dx, dbeta, dgamma = gdn_bwd_reference(x, beta, gamma, g,
                                                  ctx.inverse)
        return dx, dbeta, dgamma, None


def gdn_core(x, beta, gamma, inverse: bool = False):
    """GDN/IGDN on channel-last `x` (..., C): the CUDA kernels for a CUDA
    tensor, the plain versions for a CPU tensor; through `GDNCore` when a
    gradient is wanted."""
    if torch.is_grad_enabled() and (
        x.requires_grad or beta.requires_grad or gamma.requires_grad
    ):
        return GDNCore.apply(x, beta, gamma, bool(inverse))
    return _forward(x, beta, gamma, inverse)
