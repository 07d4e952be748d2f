"""Straight-through estimators and gradient-gated bounds (port of
``nvfpcc_tpu/ops/ste.py``).

- ``bypass_round``   — round to the integer grid, identity gradient.
- ``bypass_round16`` — round to the 1/16 grid, identity gradient.
- ``lower_bound`` / ``upper_bound`` — clamps whose gradient passes iff the
  input is inside the bound or the gradient pushes it back inside; no
  gradient flows to the bound (``lower_bound_gate``: that rule alone).

``torch.round`` rounds half to even, like ``jnp.round``.
"""

from __future__ import annotations

import torch


class _BypassRoundQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, inv_step):
        if inv_step == 1:
            return torch.round(x)
        return torch.round(x * inv_step) / inv_step

    @staticmethod
    def backward(ctx, g):
        return g, None


def bypass_round(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest integer; gradient is identity (STE)."""
    return _BypassRoundQ.apply(x, 1)


def bypass_round16(x: torch.Tensor) -> torch.Tensor:
    """Round to the 1/16 grid; gradient is identity (STE)."""
    return _BypassRoundQ.apply(x, 16)


def lower_bound_gate(x: torch.Tensor, g: torch.Tensor, bound: float) -> torch.Tensor:
    """The gradient :func:`lower_bound` passes to ``x`` when its output's
    gradient is ``g``."""
    return g * ((x >= bound) | (g < 0))


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound, gate):
        ctx.save_for_backward(x)
        ctx.bound, ctx.gate = bound, gate
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (lower_bound_gate(x, g, ctx.bound) if ctx.gate else g), None, None


class _UpperBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_max(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x <= ctx.bound) | (g > 0)), None


def lower_bound(x: torch.Tensor, bound: float, gate: bool = True) -> torch.Tensor:
    """``max(x, bound)``; gradient passes iff ``x >= bound`` or it is negative.
    ``gate=False`` passes the whole gradient, for a caller that applies
    :func:`lower_bound_gate` to a sum of such gradients itself (a block-DP
    rank's parameter gradient is one term of the group's sum, and the gate
    depends on the sum's sign)."""
    return _LowerBound.apply(x, float(bound), gate)


def upper_bound(x: torch.Tensor, bound: float) -> torch.Tensor:
    """``min(x, bound)``; gradient passes iff ``x <= bound`` or it is positive."""
    return _UpperBound.apply(x, float(bound))
