"""Plain PyTorch reference of the ``ctx_ar`` entropy model: the channel-
and position-autoregressive context predictor that a ctx_ar pack carries
(huzi96/NVFPCC ``utils/network.py:4312-4465``: ``QMaskedConv3d``,
``PredNet``, ``CtxPredLikelihoodModel``; the channel autoregression after
Minnen & Singh, "Channel-wise autoregressive entropy models for learned
image compression", ICIP 2020; the tail split is the codec's own). It is
built from the equations below and imports nothing of the program.

For integer latents y (N, 2, 2, 2, ch) and ``hidden`` units, of which the
last ``tail`` are tail units:

- layer 1: h = W1 * y + b1, a 3^3 conv with 'same' padding, ch -> hidden.
  W1 is zero on the taps at and after the center in raster order, except
  that at the center input channel i reaches hidden unit j when
  i < j mod ch;
- a = leaky(h), slope 1/16;
- layer 2: o = W2 * a + b2, hidden -> 2 ch, under the same spatial mask;
  at the center, hidden unit j reaches output k when j mod ch <= k mod ch.
  A tail unit reaches layer 2 through that gated center tap alone;
- mu = o[..., :ch], sigma = |o[..., ch:]| + 1e-6.

A decode runs 8 * ch sequential steps: raster order over the 8 positions
and, within a position, channel order; step ``p * ch + c`` decodes channel
c at position p, and its (mu, sigma) depend on the latents of earlier
steps only (:func:`step_of`).

Kernels are DHWIO (3, 3, 3, in, out): the seeded init (``seeds.py``,
stream index 10 for layer 1 and 11 for layer 2) plus a transmitted residual
on the 1/16 grid; the masks are applied here. Float32, TF32 off.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import seeds

SLOPE = 1.0 / 16.0
SIGMA_FLOOR = 1e-6
LAYERS = ("ctx1", "ctx2")


def spatial_mask() -> np.ndarray:
    """(3, 3, 3): 1 on the 13 taps before the center in raster order."""
    m = np.zeros(27, np.float32)
    m[:13] = 1.0
    return m.reshape(3, 3, 3)


def masks(ch: int, hidden: int, tail: int) -> Tuple[np.ndarray, np.ndarray]:
    """(layer 1's mask (3, 3, 3, ch, hidden), layer 2's (3, 3, 3, hidden,
    2 ch)), float32: the equations in the module docstring."""
    if not 0 <= tail < hidden:
        raise ValueError(f"tail must be in [0, hidden), got {tail}")
    sp = spatial_mask()[..., None, None]
    j = np.arange(hidden)
    m1 = np.broadcast_to(sp, (3, 3, 3, ch, hidden)).copy()
    m1[1, 1, 1] = np.arange(ch)[:, None] < (j % ch)[None, :]
    m2 = np.broadcast_to(sp, (3, 3, 3, hidden, 2 * ch)).copy()
    m2[1, 1, 1] = (j % ch)[:, None] <= (np.arange(2 * ch) % ch)[None, :]
    if tail:
        center = m2[1, 1, 1, hidden - tail:].copy()
        m2[:, :, :, hidden - tail:] = 0.0
        m2[1, 1, 1, hidden - tail:] = center
    return m1, m2


def step_of(position: int, channel: int, ch: int) -> int:
    """The decode step that decodes ``channel`` at raster ``position``."""
    return position * ch + channel


@contextlib.contextmanager
def no_tf32():
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3^3 'same' conv of an NDHWC activation with a DHWIO kernel."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, 1, 1)
    return y.permute(0, 2, 3, 4, 1)


class CtxAR:
    """The predictor of one (ch, hidden, tail) on ``device``: its seeded
    inits and its masks."""

    def __init__(self, ch: int, hidden: int, tail: int, device="cpu", tag: str = seeds.DEFAULT_TAG):
        self.ch, self.hidden, self.tail = ch, hidden, tail
        self.device = torch.device(device)
        shapes = {"ctx1": (ch, hidden), "ctx2": (hidden, 2 * ch)}
        self.init = {}
        for name, (cin, cout) in shapes.items():
            k, b = seeds.layer_init(name, "conv", cin, cout, 3, tag)
            self.init[name] = (torch.from_numpy(k).to(self.device), torch.from_numpy(b).to(self.device))
        self.mask = dict(zip(LAYERS, (torch.from_numpy(m).to(self.device) for m in masks(ch, hidden, tail))))

    def kernels(self, residuals: Dict[str, dict]) -> Dict[str, tuple]:
        """{layer: (masked kernel, bias)} of residuals ``{layer: {"kernel",
        "b"}}`` (arrays or tensors): each kernel residual rounded to the
        1/16 grid and the seeded inits added."""
        out = {}
        for name in LAYERS:
            r = torch.as_tensor(np.asarray(residuals[name]["kernel"], np.float32), device=self.device)
            rb = torch.as_tensor(np.asarray(residuals[name]["b"], np.float32), device=self.device)
            k0, b0 = self.init[name]
            out[name] = ((torch.round(r * 16.0) / 16.0 + k0) * self.mask[name], rb + b0)
        return out

    def predict(self, y: torch.Tensor, kernels: Dict[str, tuple]) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, sigma), each (N, 2, 2, 2, ch) float32, of latents ``y``
        under ``kernels`` ({layer: (kernel, bias)}, the masks applied here
        again)."""
        (k1, b1), (k2, b2) = (kernels[n] for n in LAYERS)
        with no_tf32(), torch.no_grad():
            x = y.to(self.device, torch.float32)
            h = _conv(x, k1.float() * self.mask["ctx1"], b1.float())
            a = torch.where(h >= 0, h, h * SLOPE)
            o = _conv(a, k2.float() * self.mask["ctx2"], b2.float())
        return o[..., :self.ch], o[..., self.ch:].abs() + SIGMA_FLOOR
