"""bf16 matmul precision: the port's `jax.default_matmul_precision`.

lmic_tpu's `train_cli --bf16` and `eval_model --half` run under
`jax.default_matmul_precision("bfloat16")` (lmic_tpu/utils/train.py:
127-129, lmic_tpu/utils/eval_model.py:331-340). On a TPU every
`dot_general` and `conv_general_dilated` whose `precision` is None then
takes one bf16 pass: both operands rounded to bf16, the products summed in
f32, an f32 output. Ops with an explicit `Precision.HIGHEST` stay f32:
the GDN, the bottleneck's density MLP, the wavefront step's context taps.

Here `matmul_precision("bfloat16")` is that mode, thread-local and
nestable. The port's layers call `conv2d`, `conv_transpose2d`, `linear`
and `matmul` of this module where lmic_tpu leaves the precision at its
default; outside the mode each is the plain torch op, the same call as
before. Inside it each runs a `torch.autograd.Function` that:

- forward: the op on `round_bf16` of both operands, the bias added in f32
  and never rounded;
- backward (JAX's VJP, whose transposed ops also carry precision None):
  `dx = op_T(round(g), round(w))`, `dw = op_W(round(x), round(g))`,
  `db = sum(g)` in f32, unrounded; the rounding itself passes the
  gradient straight through.

On the card the rounded operands are bf16 values held in f32, whose
products are exact in f32, so each rounded op runs with TF32 enabled for
that call only (cuDNN and cuBLAS) and restored after: exact products, f32
sums on the tensor cores, the TPU's one bf16 pass up to summation order.
Everything else keeps `set_wire_determinism()`'s TF32 off, the f32 GDN
kernels and the bottleneck's products included. The switch is process
wide, so code that runs rounded ops on two threads at once must not (see
`models/codec.py::_decompress_async`). On the CPU a rounded op is the f32
op on the rounded operands: the same function.

The mode is saved in each Function's `ctx` at the forward, never read in
the backward, which the CUDA autograd engine runs on its own thread.
`rounded_calls()` counts the rounded forwards (for the tests and
`chip_smoke.py`). A rounded op that fails raises; there is no fallback.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch
import torch.nn.functional as F

MODES = (None, "bfloat16")

_STATE = threading.local()
_COUNT_LOCK = threading.Lock()
_COUNT = [0]


@contextlib.contextmanager
def matmul_precision(mode: Optional[str]):
    """Within the block, this thread's default-precision convs and
    products run in `mode` (None: f32; "bfloat16": one bf16 pass). Nests;
    the old mode comes back on exit."""
    if mode not in MODES:
        raise ValueError(f"matmul precision is one of {MODES}, not {mode!r}")
    prev = current()
    _STATE.mode = mode
    try:
        yield
    finally:
        _STATE.mode = prev


def current() -> Optional[str]:
    """This thread's matmul precision mode."""
    return getattr(_STATE, "mode", None)


def rounded_calls() -> int:
    """Rounded forwards run since the last `reset_rounded_calls()`."""
    return _COUNT[0]


def reset_rounded_calls() -> None:
    with _COUNT_LOCK:
        _COUNT[0] = 0


def _count() -> None:
    with _COUNT_LOCK:
        _COUNT[0] += 1


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 -> f32, round to nearest even (±inf and NaN kept). The
    identity on any other dtype (bf16, f64), which XLA leaves alone."""
    if t.dtype != torch.float32:
        return t
    return t.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def _tf32(t: torch.Tensor):
    """TF32 on for cuBLAS and cuDNN while a rounded op of `t`'s device
    runs, if that is the card; the old switches come back after."""
    if not t.is_cuda:
        yield
        return
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = prev


def _bias_grad(g: torch.Tensor, dims, bias: torch.Tensor) -> torch.Tensor:
    return g.sum(dims, dtype=torch.float32).to(bias.dtype)


class _Conv(torch.autograd.Function):
    """`aten.convolution` (conv or transposed conv) on rounded operands."""

    @staticmethod
    def forward(ctx, mode, x, weight, bias, stride, padding, dilation,
                transposed, output_padding, groups):
        ctx.mode = mode
        ctx.conf = (stride, padding, dilation, transposed, output_padding,
                    groups)
        xr, wr = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xr, wr, bias)
        with _tf32(x):
            return torch.ops.aten.convolution(xr, wr, bias, *ctx.conf)

    @staticmethod
    def backward(ctx, g):
        xr, wr, bias = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[1:4]
        dx = dw = db = None
        if need_x or need_w:
            with _tf32(g):
                dx, dw, _ = torch.ops.aten.convolution_backward(
                    round_bf16(g), xr, wr, None, *ctx.conf,
                    [need_x, need_w, False])
        if need_b:
            db = _bias_grad(g, (0, 2, 3), bias)
        return None, dx, dw, db, None, None, None, None, None, None


class _Linear(torch.autograd.Function):
    """`F.linear` on rounded operands."""

    @staticmethod
    def forward(ctx, mode, x, weight, bias):
        ctx.mode = mode
        xr, wr = round_bf16(x), round_bf16(weight)
        ctx.save_for_backward(xr, wr, bias)
        with _tf32(x):
            return F.linear(xr, wr, bias)

    @staticmethod
    def backward(ctx, g):
        xr, wr, bias = ctx.saved_tensors
        gr = round_bf16(g)
        dx = dw = db = None
        with _tf32(g):
            if ctx.needs_input_grad[1]:
                dx = gr @ wr
            if ctx.needs_input_grad[2]:
                dw = (gr.reshape(-1, gr.shape[-1]).t()
                      @ xr.reshape(-1, xr.shape[-1]))
        if ctx.needs_input_grad[3]:
            db = _bias_grad(g.reshape(-1, g.shape[-1]), 0, bias)
        return None, dx, dw, db


class _Matmul(torch.autograd.Function):
    """`torch.matmul` on rounded operands (1-D operands and broadcast
    batch dimensions as `torch.matmul` takes them)."""

    @staticmethod
    def forward(ctx, mode, a, b):
        ctx.mode = mode
        ar, br = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(ar, br)
        with _tf32(a):
            return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        a2 = ar[None] if ar.dim() == 1 else ar
        b2 = br[:, None] if br.dim() == 1 else br
        gr = round_bf16(g)
        if ar.dim() == 1:
            gr = gr.unsqueeze(-2)
        if br.dim() == 1:
            gr = gr.unsqueeze(-1)
        da = db = None
        with _tf32(g):
            if ctx.needs_input_grad[1]:
                da = (gr @ b2.mT).sum_to_size(a2.shape).reshape(ar.shape)
            if ctx.needs_input_grad[2]:
                db = (a2.mT @ gr).sum_to_size(b2.shape).reshape(br.shape)
        return None, da, db


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1,
           groups=1):
    """`F.conv2d`, on rounded operands under the bf16 mode."""
    mode = current()
    if mode is None:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    _count()
    pair = torch.nn.modules.utils._pair
    return _Conv.apply(mode, x, weight, bias, pair(stride), pair(padding),
                       pair(dilation), False, (0, 0), groups)


def conv_transpose2d(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1):
    """`F.conv_transpose2d`, on rounded operands under the bf16 mode."""
    mode = current()
    if mode is None:
        return F.conv_transpose2d(x, weight, bias, stride, padding,
                                  output_padding, groups, dilation)
    _count()
    pair = torch.nn.modules.utils._pair
    return _Conv.apply(mode, x, weight, bias, pair(stride), pair(padding),
                       pair(dilation), True, pair(output_padding), groups)


def linear(x, weight, bias=None):
    """`F.linear`, on rounded operands under the bf16 mode."""
    mode = current()
    if mode is None:
        return F.linear(x, weight, bias)
    _count()
    return _Linear.apply(mode, x, weight, bias)


def matmul(a, b):
    """`torch.matmul`, on rounded operands under the bf16 mode."""
    mode = current()
    if mode is None:
        return torch.matmul(a, b)
    _count()
    return _Matmul.apply(mode, a, b)
