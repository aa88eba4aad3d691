"""Core autograd ops: bounded max with pass-through gradient, STE rounding,
non-negative reparametrization.

Counterpart of lmic_tpu/ops/math.py. Reference semantics:
compressai/ops/bound_ops.py:36-80, compressai/ops/parametrizers.py:38-64,
compressai/ops/ops.py:35-49.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x, bound)
        return torch.maximum(x, bound)

    @staticmethod
    def backward(ctx, g):
        x, bound = ctx.saved_tensors
        pass_through = (x >= bound) | (g < 0)
        # no gradient w.r.t. the bound (the reference returns None for it)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound) -> torch.Tensor:
    """`max(x, bound)` with a custom gradient.

    The gradient passes through where `x >= bound`, or where the incoming
    gradient would push `x` up toward the bound (grad < 0 in minimization
    convention). Reference: compressai/ops/bound_ops.py:40-42.
    """
    bound = torch.as_tensor(bound, dtype=x.dtype, device=x.device)
    return _LowerBound.apply(x, bound)


class LowerBound:
    """Callable wrapper matching the reference module API."""

    def __init__(self, bound: float):
        self.bound = float(bound)

    def __call__(self, x):
        return lower_bound(x, self.bound)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round (half to even) with a straight-through (identity) gradient.

    Reference: compressai/ops/ops.py:35-49 (`round(x) - detach(x) + x`).
    """
    return torch.round(x) - x.detach() + x


class NonNegativeParametrizer:
    """sqrt-space reparametrization keeping values >= `minimum`.

    Stored parameter p relates to the effective value v by
    `v = lower_bound(p, sqrt(minimum + eps^2))^2 - eps^2` with
    eps = 2^-18. Reference: compressai/ops/parametrizers.py:38-64.
    """

    def __init__(self, minimum: float = 0.0, reparam_offset: float = 2**-18):
        self.minimum = float(minimum)
        self.reparam_offset = float(reparam_offset)
        self.pedestal = self.reparam_offset**2
        self._bound = (self.minimum + self.pedestal) ** 0.5

    def init(self, x: torch.Tensor) -> torch.Tensor:
        """Map an initial effective value to parameter space."""
        return torch.sqrt(torch.clamp(x + self.pedestal, min=self.pedestal))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return lower_bound(x, self._bound) ** 2 - self.pedestal


def from_amp(x: torch.Tensor) -> torch.Tensor:
    """Upcast AMP activations (bf16/f16) to f32 at the entropy/loss
    boundaries; identity for f32 and f64 (never downcasts)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x
