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

Masked convs (the latent context model, ``entropy_mode`` ctx / ctx_ar): a
``QSpec`` with a ``mask`` zeroes kernel taps at and after the center in
raster order (or gates the center tap by channel groups); the mask is
applied after the seeded init is added back, as the JAX package does.

On a CUDA card the port's hand-written transposed conv kernel
(``kernels/conv_transpose.py``) runs the transposed convs' forward and the
direct convs' input gradient (itself a transposed conv), its direct conv
kernel (``kernels/conv3d.py``) the direct convs' f32 forward; cuDNN the
rest (the bf16 direct forward, the weight gradients, the transposed convs'
backward). On the CPU every conv is ``F.conv3d``/``F.conv_transpose3d``.

Mixed-precision training (``compute_dtype="bf16"``): the master residual,
the q-phase quantization and the seeded-init add stay f32
(``effective_kernel``); then activation, effective kernel and bias are cast
to bf16 and only the conv arithmetic runs there. Without a compute dtype
nothing is cast, and the conv runs in the operands' dtype: f32, or bf16
for a decoder cast to bf16 (the bf16 reconstruction, where the residual,
the STE and the init add are bf16 too). Whenever the conv runs in bf16 the
bias is added after it, in bf16, as XLA does (conv result rounded to bf16,
then ``+ b``); an f32 conv takes the bias fused.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nvfpcc_tpu_torch.kernels.conv_transpose import Conv3d, conv_transpose3d
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
    # causal tap mask (k,k,k,1,1) or (k,k,k,in,out), or None; applied AFTER
    # the init is added back
    mask: np.ndarray = field(default=None, repr=False)

    @property
    def kernel_shape(self) -> Tuple[int, ...]:
        k = self.kernel_size
        return (k, k, k, self.in_ch, self.out_ch)

    @property
    def mask_flat_indices(self) -> np.ndarray:
        """Flat indices (into the C-order DHWIO kernel) of the mask-visible
        taps: the only entries that affect the output, hence the only ones
        coded."""
        if self.mask is None:
            raise ValueError("not a masked conv")
        return np.flatnonzero(np.broadcast_to(self.mask, self.kernel_shape).reshape(-1))


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


def causal_mask(kernel_size: int) -> np.ndarray:
    """Strict raster-order causal mask (k,k,k,1,1): taps whose (d,h,w) offset
    is lexicographically before the center are 1, the center and everything
    after are 0. On a latent grid no wider than the raster stride, output
    position i then depends only on input positions < i in C order."""
    if kernel_size % 2 != 1:
        raise ValueError("causal mask needs an odd kernel")
    k, h = kernel_size, kernel_size // 2
    m = np.zeros((k, k, k, 1, 1), np.float32)
    m[:h, :, :] = 1.0
    m[h, :h, :] = 1.0
    m[h, h, :h] = 1.0
    return m


def channel_ar_mask(kernel_size: int, in_ch: int, out_ch: int, in_group, out_group,
                    center_strict: bool) -> np.ndarray:
    """The spatial causal mask plus a center tap gated by channel groups: the
    same-position tap from input unit i to output unit o is visible iff
    ``in_group(i) < out_group(o)`` (``center_strict``, first layer) or
    ``<=`` (second layer), so (mu_c, sigma_c) see exactly the same-position
    channels before c plus everything the spatial mask allows."""
    k, h = kernel_size, kernel_size // 2
    m = np.broadcast_to(causal_mask(kernel_size), (k, k, k, in_ch, out_ch)).copy()
    gi = np.asarray([in_group(i) for i in range(in_ch)])
    go = np.asarray([out_group(o) for o in range(out_ch)])
    center = gi[:, None] < go[None, :] if center_strict else gi[:, None] <= go[None, :]
    m[h, h, h] = center.astype(np.float32)
    return m


def make_masked_qspec(key: seeds.SeedKey, in_ch: int, out_ch: int, kernel_size: int = 3,
                      mask: Optional[np.ndarray] = None) -> QSpec:
    """Seeded causal masked conv: stride 1, 'same' padding, the strict raster
    mask (or an explicit ``mask``, e.g. the channel-AR one)."""
    base = make_qspec(key, "conv", in_ch, out_ch, kernel_size, 1, kernel_size // 2)
    return dataclasses.replace(base, mask=causal_mask(kernel_size) if mask is None else mask)


def as_compute_dtype(compute_dtype):
    """Normalize a compute-dtype knob: None/"f32" -> None (full precision),
    "bf16"/``torch.bfloat16`` -> ``torch.bfloat16``."""
    if compute_dtype is None or compute_dtype in ("f32", "float32", torch.float32):
        return None
    if compute_dtype in ("bf16", "bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"unsupported compute_dtype: {compute_dtype!r}")


def _run_conv(conv, x, w, b, compute_dtype):
    """``conv(x, w, bias)`` on NCDHW views in the compute dtype (default: the
    operands' own); f32 fuses the bias, bf16 adds it after the rounded
    conv result. Returns NDHWC."""
    cd = as_compute_dtype(compute_dtype) or x.dtype
    x, w = x.to(cd), w.to(cd)
    if cd == torch.float32:
        return conv(x, w, b).permute(0, 2, 3, 4, 1)
    return conv(x, w, None).permute(0, 2, 3, 4, 1) + b.to(cd)


def _run_cuda(fn, x, kernel, b, compute_dtype, *conv):
    """``fn(x, kernel, bias, *conv)`` (a ``kernels/conv_transpose.py``
    autograd Function's ``apply``) on NDHWC ``x`` and the raw kernel in the
    compute dtype, with ``_run_conv``'s bias rule."""
    cd = as_compute_dtype(compute_dtype) or x.dtype
    x, kernel = x.to(cd), kernel.to(cd)
    if cd == torch.float32:
        return fn(x, kernel, b, *conv)
    return fn(x, kernel, None, *conv) + b.to(cd)


def conv3d_ndhwc(x, kernel, b, stride: int, padding: int, compute_dtype=None) -> torch.Tensor:
    """Direct conv: NDHWC activation, DHWIO kernel. On a CUDA tensor the
    port's direct conv kernel runs an f32 forward (cuDNN a bf16 one), cuDNN
    the weight gradient, the port's transposed conv kernel the input
    gradient (``kernels/conv_transpose.py:Conv3d``)."""
    if x.device.type == "cuda":
        return _run_cuda(Conv3d.apply, x, kernel, b, compute_dtype, stride, padding)
    return _run_conv(
        lambda x, w, b: F.conv3d(x, w, b, stride, padding),
        x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2), b, compute_dtype,
    )


def conv_transpose3d_ndhwc(x, kernel, b, stride: int, padding: int, output_padding: int,
                           compute_dtype=None):
    """Transposed conv (torch semantics): NDHWC activation, DHWIO kernel with
    I = the transposed op's input channels; no flip. On a CUDA tensor the
    forward is the port's hand-written kernel (``kernels/conv_transpose.py``;
    cuDNN runs its backward); on the CPU ``F.conv_transpose3d``."""
    if x.device.type == "cuda":
        return _run_cuda(conv_transpose3d, x, kernel, b, compute_dtype, stride, padding, output_padding)
    return _run_conv(
        lambda x, w, b: F.conv_transpose3d(x, w, b, stride, padding, output_padding),
        x.permute(0, 4, 1, 2, 3), kernel.permute(3, 4, 0, 1, 2), b, compute_dtype,
    )


class QConv3d(nn.Module):
    """Quantization-aware seeded conv: ``kernel``/``b`` are the residuals."""

    def __init__(self, spec: QSpec):
        super().__init__()
        self.spec = spec
        self.kernel = nn.Parameter(torch.zeros(spec.kernel_shape, dtype=torch.float32))
        self.register_buffer("kernel_init", torch.from_numpy(np.array(spec.kernel_init)))
        self.b = nn.Parameter(torch.zeros((spec.out_ch,), dtype=torch.float32))
        self.register_buffer("b_init", torch.from_numpy(np.array(spec.b_init)))
        if spec.mask is not None:
            self.register_buffer("mask", torch.from_numpy(np.array(spec.mask, np.float32)))
            self.register_buffer("mask_idx", torch.from_numpy(spec.mask_flat_indices))
        else:
            self.mask = self.mask_idx = None

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
        k = k + self.kernel_init
        return k if self.mask is None else k * self.mask

    def effective_bias(self):
        return self.b + self.b_init

    def forward(self, x, q: int = 2, noise: Optional[torch.Tensor] = None, compute_dtype=None):
        s = self.spec
        return conv3d_ndhwc(
            x, self.effective_kernel(q, noise), self.effective_bias(), s.stride, s.padding,
            compute_dtype,
        )


class QConvTranspose3d(QConv3d):
    """Quantization-aware seeded transposed conv."""

    def forward(self, x, q: int = 2, noise: Optional[torch.Tensor] = None, compute_dtype=None):
        s = self.spec
        return conv_transpose3d_ndhwc(
            x, self.effective_kernel(q, noise), self.effective_bias(), s.stride, s.padding,
            s.output_padding, compute_dtype,
        )


class IConv3d(QConv3d):
    """Non-quantized seeded conv (residual + init, no rounding)."""

    def forward(self, x, compute_dtype=None):
        s = self.spec
        return conv3d_ndhwc(
            x, self.effective_kernel(q=0), self.effective_bias(), s.stride, s.padding,
            compute_dtype,
        )
