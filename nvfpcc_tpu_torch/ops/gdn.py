"""Generalized divisive normalization for channels-last 3-D grids (port of
``nvfpcc_tpu/ops/gdn.py``).

``y_o = x_o / sqrt(beta_o + sum_i gamma[o,i] * x_i^2)`` (GDN) and
``y_o = x_o * sqrt(...)`` (IGDN), with ``beta``/``gamma`` reparameterized as
``sqrt(v + pedestal)`` and clamped by the gradient-gated ``lower_bound``.
"""

from __future__ import annotations

import torch
from torch import nn

from nvfpcc_tpu_torch.ops.ste import lower_bound, lower_bound_gate

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_MIN = 1e-6
BETA_BOUND = (BETA_MIN + PEDESTAL) ** 0.5
GAMMA_BOUND = REPARAM_OFFSET
GAMMA_INIT = 0.1


def gdn_init(ch: int) -> dict:
    """Initial ``{"beta": (ch,), "gamma": (ch, ch)}`` (out, in), float32."""
    beta = torch.sqrt(torch.ones((ch,), dtype=torch.float32) + PEDESTAL)
    gamma = torch.sqrt(GAMMA_INIT * torch.eye(ch, dtype=torch.float32) + PEDESTAL)
    return {"beta": beta, "gamma": gamma}


def _norm_pool(params: dict, x: torch.Tensor, gate: bool = True) -> torch.Tensor:
    beta = lower_bound(params["beta"], BETA_BOUND, gate)
    beta = beta * beta - PEDESTAL
    gamma = lower_bound(params["gamma"], GAMMA_BOUND, gate)
    gamma = gamma * gamma - PEDESTAL
    # a bf16 activation (mixed-precision training) is squared in bf16 and
    # the pool is taken in f32, so GDN/IGDN return f32 and the next conv
    # casts again; torch.einsum does not promote mixed dtypes by itself
    sq = (x * x).to(gamma.dtype)
    return torch.sqrt(torch.einsum("...i,oi->...o", sq, gamma) + beta)


def gdn_apply(params: dict, x: torch.Tensor, gate: bool = True) -> torch.Tensor:
    """GDN: divide by the norm pool."""
    return x / _norm_pool(params, x, gate)


def igdn_apply(params: dict, x: torch.Tensor, gate: bool = True) -> torch.Tensor:
    """IGDN: multiply by the norm pool."""
    return x * _norm_pool(params, x, gate)


class GDN(nn.Module):
    """GDN (``inverse=False``) or IGDN over the last (channel) axis; the
    parameters ``beta``/``gamma`` carry the JAX tree's leaf names."""

    def __init__(self, ch: int, inverse: bool = False):
        super().__init__()
        init = gdn_init(ch)
        self.beta = nn.Parameter(init["beta"])
        self.gamma = nn.Parameter(init["gamma"])
        self.inverse = inverse
        # block-DP: the bounds pass the rank's whole gradient, and
        # gate_grads() gates the group's sum (see ops.ste.lower_bound)
        self.defer_gate = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {"beta": self.beta, "gamma": self.gamma}
        gate = not self.defer_gate
        return igdn_apply(params, x, gate) if self.inverse else gdn_apply(params, x, gate)

    def gate_grads(self) -> None:
        """Apply the bounds' gates to ``beta.grad`` and ``gamma.grad``."""
        for p, bound in ((self.beta, BETA_BOUND), (self.gamma, GAMMA_BOUND)):
            p.grad = lower_bound_gate(p.detach(), p.grad, bound)
