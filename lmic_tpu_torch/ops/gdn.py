"""GDN/IGDN forward: the CUDA kernel (csrc/gdn_fwd.cu) and its plain version.

Counterpart of lmic_tpu/ops/pallas_gdn.py (`gdn_core`, `_gdn_jnp`,
`_kernel`). `gdn_core(x, beta, gamma, inverse)` takes POST-reparametrization
beta/gamma and channel-last activations `(..., C)`:

- a CUDA tensor goes to the hand-written kernel, `gdn_fwd`; it never falls
  back to the plain version, and it raises on a dtype or shape the kernel
  does not take;
- a CPU tensor goes to `gdn_reference`, the same formula in plain torch.

The fused backward (`pallas_gdn._bwd_kernel`) is ported with the training
slice; until then the CUDA path refuses tensors that require a gradient.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from lmic_tpu_torch.ops import _build

# Launches of each kernel of this module, counted where the wrapper launches
# it and nowhere else; a caller resets and reads it to show which path ran.
LAUNCHES = {"gdn_fwd": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LOCK = threading.Lock()
_lib = None


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = _build.load("gdn_fwd.cu")
            lib.lmic_gdn_fwd.restype = ctypes.c_int
            lib.lmic_gdn_fwd.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.lmic_gdn_fwd_max_channels.restype = ctypes.c_int
            lib.lmic_gdn_error_string.restype = ctypes.c_char_p
            lib.lmic_gdn_error_string.argtypes = [ctypes.c_int]
            _lib = lib
    return _lib


def gdn_reference(x, beta, gamma, inverse: bool = False):
    """y_i = x_i * (beta_i + sum_j gamma_ij x_j^2)^(-1/2 or +1/2), plain torch.

    Mirrors `_gdn_jnp`: x^2 in the input dtype, the channel product and the
    norm in f32 (f64 for f64 inputs), the scale cast back to the input dtype
    before the multiply. x: (..., C); beta: (C,); gamma: (C_out, C_in).
    """
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    norm = torch.matmul((x * x).to(acc), gamma.to(acc).t()) + beta.to(acc)
    scale = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return x * scale.to(x.dtype)


def gdn_fwd(x, beta, gamma, inverse: bool = False):
    """Launch the CUDA kernel on CUDA tensors x (..., C), beta (C,) and
    gamma (C, C) of one dtype, float32 or bfloat16."""
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"gdn_fwd takes float32 or bfloat16, got {x.dtype}")
    C = x.shape[-1]
    if tuple(beta.shape) != (C,) or tuple(gamma.shape) != (C, C):
        raise ValueError(
            f"gdn_fwd: beta {tuple(beta.shape)} / gamma "
            f"{tuple(gamma.shape)} do not fit {C} channels"
        )
    for name, t in (("beta", beta), ("gamma", gamma)):
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"gdn_fwd: {name} is {t.dtype} on {t.device}, x is "
                f"{x.dtype} on {x.device}"
            )
    if torch.is_grad_enabled() and (
        x.requires_grad or beta.requires_grad or gamma.requires_grad
    ):
        raise NotImplementedError(
            "the GDN backward kernel is ported with the training slice "
            "(ROADMAP.md, queue B item 2); run the CUDA path under "
            "torch.no_grad()"
        )
    lib = _load()
    if C > lib.lmic_gdn_fwd_max_channels():
        raise ValueError(f"gdn_fwd: {C} channels exceed the kernel's tile")
    if not x.is_contiguous():
        x = x.contiguous()  # explicit copy: the kernel reads (n, C) rows
    gamma_t = gamma.t().contiguous()
    beta = beta.contiguous()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    n = x.numel() // C if C else 0
    if n == 0:
        return y
    with torch.cuda.device(x.device):
        err = lib.lmic_gdn_fwd(
            x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), y.data_ptr(),
            n, C, _DTYPE_CODES[x.dtype], int(bool(inverse)),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(
            f"gdn_fwd launch failed: {lib.lmic_gdn_error_string(err).decode()}"
        )
    LAUNCHES["gdn_fwd"] += 1
    return y


def gdn_core(x, beta, gamma, inverse: bool = False):
    """GDN/IGDN forward on channel-last `x` (..., C): the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if x.device.type == "cuda":
        return gdn_fwd(x, beta, gamma, inverse)
    if x.device.type == "cpu":
        return gdn_reference(x, beta, gamma, inverse)
    raise ValueError(f"gdn_core: no GDN path for device {x.device}")
