"""The direct stride-1 3-D conv kernel, f32: CUDA wrapper, launch plan and
plain version.

``launch(x, kernel, bias, stride, padding)`` is torch's ``conv3d`` (a
cross-correlation with zero padding, one group, dilation 1) on the port's
layouts: an NDHWC activation, a DHWIO kernel and NDHWC out, all f32. It
replaces no TPU kernel (the JAX package left these convs to XLA). On the
card ``kernels/conv_transpose.py:Conv3d`` runs every f32 direct conv's
forward through it (the decoder's conv1, conv2 and heads, the latent
generator, the ctx predictor's masked convs), which cuDNN ran as
``implicit_convolveNd_sgemm`` at about 4% of the card's f32 FFMA rate;
bf16 operands keep cuDNN's forward.

- ``launch`` runs the hand-written kernel ``csrc/conv3d.cu`` (one launch;
  see the source for the design), built into the port's kernel library at
  first use (``kernels/build.py``) and bound with ``ctypes``. It takes CUDA
  f32 tensors at stride 1 and raises on anything else: there is no
  fallback.
- ``conv3d_ref`` is the plain PyTorch version, on any device: the kernel's
  Cin chunks and its summation order (chunk, kd, ci, kh, kw), with the bias
  added last. The CPU tests and ``chip_smoke.py`` hold the kernel to it;
  the port's CPU path keeps ``F.conv3d``.
- ``plan`` is the launch plan: the instantiation, from (k, Cout), the CTA
  tile and the Cin chunk, from the layer's shape alone, never from the
  batch, so a block's output bits do not depend on the call's other blocks.

``LAUNCHES`` counts the wrapper's kernel runs (one per launch; inside a
CUDA graph only the capture counts), so a caller can show that a path went
through the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nvfpcc_tpu_torch.kernels.build import error_string, load_library

MAX_THREADS = 128  # threads of a CTA (the kernel's launch bound)
MAX_STRIPS = 4  # strips of R outputs a CTA row takes along W
MAX_ROWS = 8  # output rows a CTA takes along H
SMEM_BUDGET = 56 * 1024  # bytes a CTA stages: four CTAs fit an SM

LAUNCHES = 0


class Plan(NamedTuple):
    out: Tuple[int, int, int]  # output edges (D, H, W)
    variant: Tuple[int, int, int]  # the instantiation: (k or 0 for run time, COT, R)
    tile: Tuple[int, int, int, int]  # a CTA's blocks, output planes, rows, strips of R
    tiles: Tuple[int, int, int]  # tiles along D, H, W
    cic: int  # Cin staged at once
    halo: Tuple[int, int, int]  # a block's staged planes, rows, row stride (floats)
    smem: int  # bytes of shared memory a CTA stages


def _variant(k: int, cout: int) -> Tuple[int, int, int]:
    """(K, COT, R) of the instantiation for a k-tap conv to Cout channels:
    k4 to several channels (conv1, conv2) and k3 to one (the heads) give a
    thread strips of R outputs from a staged halo; other k3 convs (the ctx
    predictor) and the generic one (k at run time: the latent generator,
    any other shape) one output a thread, its inputs read from device
    memory."""
    if k == 4 and cout > 1:
        return 4, 8, 8
    if k == 3:
        return (3, 1, 8) if cout == 1 else (3, 4, 1)
    return 0, 4, 1


def _smem(k: int, cot: int, cic: int, tn: int, halo) -> int:
    return 4 * (-(-k**3 * cic * cot // 4) * 4 + cic * tn * int(np.prod(halo)))


@functools.lru_cache(maxsize=64)
def plan(in_shape: Tuple[int, int, int], cin: int, cout: int, k: int, padding: int) -> Plan:
    """The launch plan of a stride-1 layer: everything of a launch but the
    batch. Raises if the layer has no output or one input channel's halo
    and weights exceed ``SMEM_BUDGET``."""
    if min(cin, cout, k) < 1 or padding < 0:
        raise ValueError(f"bad conv: Cin {cin}, Cout {cout}, k {k}, padding {padding}")
    out = tuple(e + 2 * padding - k + 1 for e in in_shape)
    if min(out) < 1:
        raise ValueError(f"conv k{k} padding {padding} of a {tuple(in_shape)} input has no output")
    kt, cot, r = _variant(k, cout)
    sw = min(-(-out[2] // r), MAX_STRIPS)
    th = min(out[1], MAX_ROWS)
    td = min(out[0], max(1, MAX_THREADS // (sw * th)))
    tiles = (-(-out[0] // td), -(-out[1] // th), -(-out[2] // (sw * r)))
    tn = MAX_THREADS // (td * th * sw) if tiles == (1, 1, 1) else 1  # small blocks: several a CTA
    halo = (0, 0, 0)  # single outputs a thread read their inputs from device memory
    if r > 1:
        rs = sw * r + -(-(k - 1) // 4) * 4  # the strip's float4 loads stay in the row
        if rs // 4 % 2 == 0:
            rs += 4  # rows 4 mod 8 floats apart: a load phase's 2 rows x 4 strips hit distinct banks
        halo = (td + k - 1, th + k - 1, rs)
    cic = cin
    while cic > 1 and _smem(k, cot, cic, tn, halo) > SMEM_BUDGET:
        cic -= 1
    if _smem(k, cot, cic, tn, halo) > SMEM_BUDGET:
        raise ValueError(f"conv k{k}: one input channel's halo and weights exceed {SMEM_BUDGET} bytes "
                         "of shared memory")
    if cic < cin and cic >= 4:
        cic -= cic % 4  # whole float4s of a voxel's channels a chunk
    return Plan(out, (kt, cot, r), (tn, td, th, sw), tiles, cic, halo, _smem(k, cot, cic, tn, halo))


def check_operands(x: torch.Tensor, kernel: torch.Tensor, bias) -> None:
    """Raise unless ``x`` is NDHWC, ``kernel`` a cubic DHWIO kernel on x's
    channels and ``bias`` (or None) one value an output channel: the
    shapes both conv kernels take."""
    if x.ndim != 5 or kernel.ndim != 5:
        raise ValueError(f"need NDHWC x and DHWIO kernel, got {tuple(x.shape)}, {tuple(kernel.shape)}")
    k = kernel.shape[0]
    if kernel.shape[:3] != (k, k, k) or kernel.shape[3] != x.shape[4]:
        raise ValueError(f"kernel {tuple(kernel.shape)} does not fit x {tuple(x.shape)}")
    if bias is not None and tuple(bias.shape) != (kernel.shape[4],):
        raise ValueError(f"bias {tuple(bias.shape)} does not fit kernel {tuple(kernel.shape)}")


def launch(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int, padding: int) -> torch.Tensor:
    """One kernel run on the card (no autograd): contiguous NDHWC ``x``,
    DHWIO ``kernel`` and ``bias`` (or None), all f32 on one CUDA device, at
    stride 1; returns NDHWC f32."""
    global LAUNCHES
    check_operands(x, kernel, bias)
    if stride != 1:
        raise ValueError(f"the direct conv kernel takes stride 1 only, got {stride}")
    if any(t is not None and t.dtype != torch.float32 for t in (x, kernel, bias)):
        raise TypeError(f"the direct conv kernel needs float32 x, kernel and bias, got {x.dtype}, "
                        f"{kernel.dtype}, {None if bias is None else bias.dtype}")
    if any(t is not None and t.device != x.device for t in (kernel, bias)) or x.device.type != "cuda":
        raise ValueError(f"the direct conv kernel needs CUDA tensors on one device, got {x.device}, "
                         f"{kernel.device}, {None if bias is None else bias.device}")
    if not (x.is_contiguous() and kernel.is_contiguous() and (bias is None or bias.is_contiguous())):
        raise ValueError("x, kernel and bias must be contiguous")
    n, cin, cout, k = x.shape[0], x.shape[4], kernel.shape[4], kernel.shape[0]
    p = plan(tuple(x.shape[1:4]), cin, cout, k, padding)
    out = torch.empty((n, *p.out, cout), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    geom = np.array([*x.shape[1:4], *p.out, *p.tile, *p.tiles, p.cic, *p.halo], np.int32)
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nvfpcc_conv3d(x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(),
                               out.data_ptr(), n, cin, cout, k, padding, geom.ctypes.data, *p.variant, stream)
    if rc != 0:
        raise RuntimeError(f"direct conv kernel launch failed: {error_string(rc)}")
    LAUNCHES += 1
    return out


def conv3d_ref(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int, padding: int) -> torch.Tensor:
    """Plain PyTorch version, on any device: f32 sums over the kernel's Cin
    chunks (``plan``), and in each over kd, ci, kh, kw in that order, of the
    input window times the tap's Cout weights; the bias added last. It takes
    any stride (the outputs are the stride-1 ones it subsamples), so that
    it can stand in for the kernel where a test runs the autograd Function
    on the CPU."""
    check_operands(x, kernel, bias)
    if stride < 1:
        raise ValueError(f"stride must be at least 1, got {stride}")
    n, cin, cout, k = x.shape[0], x.shape[4], kernel.shape[4], kernel.shape[0]
    cic = plan(tuple(x.shape[1:4]), cin, cout, k, padding).cic
    out = [(e + 2 * padding - k) // stride + 1 for e in x.shape[1:4]]
    xp = F.pad(x.float(), (0, 0) + (padding, padding) * 3)
    wf = kernel.float()
    acc = torch.zeros((n, *out, cout), dtype=torch.float32, device=x.device)
    span = [stride * (o - 1) + 1 for o in out]
    for ci0 in range(0, cin, cic):
        for kd in range(k):
            for ci in range(ci0, min(ci0 + cic, cin)):
                for kh in range(k):
                    for kw in range(k):
                        win = xp[:, kd:kd + span[0]:stride, kh:kh + span[1]:stride, kw:kw + span[2]:stride, ci, None]
                        acc.addcmul_(win, wf[kd, kh, kw, ci])
    if bias is not None:
        acc += bias.float()
    return acc
