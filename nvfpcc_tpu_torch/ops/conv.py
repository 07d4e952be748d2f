"""Seeded, quantization-aware 3-D convolutions (port of ``nvfpcc_tpu/ops/conv.py``).

Every compressible layer splits its kernel into a deterministic seeded init
(regenerated by the decoder, never transmitted; a buffer here) plus a learned
residual (an ``nn.Parameter``); only the residual is quantized and coded.
q=1 adds ``noise / 16`` to the residual (``noise`` ~ U(-0.5, 0.5) is passed
in, there is no hidden RNG), q=2 rounds it to the 1/16 grid with an STE.

Layout at the public surface is the JAX package's: activations NDHWC, kernels
stored DHWIO. The layout change happens here, inside the conv:

- conv weight (O, I, k, k, k) = ``kernel.permute(4, 3, 0, 1, 2)``;
- transposed-conv weight (I, O, k, k, k) = ``kernel.permute(3, 4, 0, 1, 2)``
  with NO spatial flip — the JAX package flips only because it expresses the
  transposed conv as an input-dilated direct conv;
- ``x.permute(0, 4, 1, 2, 3)`` of an NDHWC tensor is an NCDHW view in
  ``channels_last_3d`` memory format, which cuDNN takes without a copy.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nvfpcc_tpu_torch.utils import seeds
from nvfpcc_tpu_torch.ops.ste import bypass_round16

IQ = 16  # residuals live on the 1/16 grid: q=1 noise is U(-0.5, 0.5) / IQ


@dataclass(frozen=True)
class QSpec:
    """Static description of one (de)conv layer, including its seeded inits
    (numpy float32, bit-identical to the JAX package's)."""

    kind: str  # "conv" | "conv_transpose"
    in_ch: int
    out_ch: int
    kernel_size: int
    stride: int = 1
    padding: int = 0
    output_padding: int = 0
    kernel_init: np.ndarray = field(default=None, repr=False)
    b_init: np.ndarray = field(default=None, repr=False)

    @property
    def kernel_shape(self) -> Tuple[int, ...]:
        k = self.kernel_size
        return (k, k, k, self.in_ch, self.out_ch)


def make_qspec(
    key: seeds.SeedKey,
    kind: str,
    in_ch: int,
    out_ch: int,
    kernel_size: int,
    stride: int = 1,
    padding: int = 0,
    output_padding: int = 0,
) -> QSpec:
    """Layer spec with seeded Kaiming init buffers from the shared seed
    stream (fan-in: in*k^3 for conv, out*k^3 for transposed; bias bound
    1/sqrt(in_ch) for both). Every layer of the codec has a bias."""
    k = kernel_size
    if kind == "conv":
        fan_in = in_ch * k**3
    elif kind == "conv_transpose":
        fan_in = out_ch * k**3
    else:
        raise ValueError(f"unknown conv kind: {kind}")
    kernel_init = seeds.kaiming_uniform(
        seeds.sub_key(key, "kernel"), (k, k, k, in_ch, out_ch), fan_in
    )
    b_init = seeds.uniform_bias(seeds.sub_key(key, "bias"), (out_ch,), in_ch)
    return QSpec(
        kind=kind, in_ch=in_ch, out_ch=out_ch, kernel_size=kernel_size, stride=stride,
        padding=padding, output_padding=output_padding, kernel_init=kernel_init, b_init=b_init,
    )


def conv3d_ndhwc(x, kernel, b, stride: int, padding: int) -> torch.Tensor:
    """Direct conv: NDHWC activation, DHWIO kernel."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2), b, stride, padding)
    return y.permute(0, 2, 3, 4, 1)


def conv_transpose3d_ndhwc(x, kernel, b, stride: int, padding: int, output_padding: int):
    """Transposed conv (torch semantics): NDHWC activation, DHWIO kernel with
    I = the transposed op's input channels; no flip."""
    y = F.conv_transpose3d(
        x.permute(0, 4, 1, 2, 3), kernel.permute(3, 4, 0, 1, 2), b, stride, padding,
        output_padding,
    )
    return y.permute(0, 2, 3, 4, 1)


class QConv3d(nn.Module):
    """Quantization-aware seeded conv: ``kernel``/``b`` are the residuals."""

    def __init__(self, spec: QSpec):
        super().__init__()
        self.spec = spec
        self.kernel = nn.Parameter(torch.zeros(spec.kernel_shape, dtype=torch.float32))
        self.register_buffer("kernel_init", torch.from_numpy(np.array(spec.kernel_init)))
        self.b = nn.Parameter(torch.zeros((spec.out_ch,), dtype=torch.float32))
        self.register_buffer("b_init", torch.from_numpy(np.array(spec.b_init)))

    def effective_kernel(self, q: int, noise: Optional[torch.Tensor] = None):
        """Quantize the residual per phase ``q`` and add the seeded init back."""
        if q == 1:
            if noise is None:
                raise ValueError("q=1 (noise phase) needs the kernel noise U(-0.5, 0.5)")
            k = self.kernel + noise * (1.0 / IQ)
        elif q == 2:
            k = bypass_round16(self.kernel)
        else:
            k = self.kernel
        return k + self.kernel_init

    def effective_bias(self):
        return self.b + self.b_init

    def forward(self, x, q: int = 2, noise: Optional[torch.Tensor] = None):
        s = self.spec
        return conv3d_ndhwc(x, self.effective_kernel(q, noise), self.effective_bias(), s.stride, s.padding)


class QConvTranspose3d(QConv3d):
    """Quantization-aware seeded transposed conv."""

    def forward(self, x, q: int = 2, noise: Optional[torch.Tensor] = None):
        s = self.spec
        return conv_transpose3d_ndhwc(
            x, self.effective_kernel(q, noise), self.effective_bias(), s.stride, s.padding,
            s.output_padding,
        )


class IConv3d(QConv3d):
    """Non-quantized seeded conv (residual + init, no rounding)."""

    def forward(self, x):
        s = self.spec
        return conv3d_ndhwc(x, self.effective_kernel(q=0), self.effective_bias(), s.stride, s.padding)
