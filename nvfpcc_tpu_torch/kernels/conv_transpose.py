"""The transposed 3-D conv kernel: CUDA wrapper, its two autograd
Functions and its plain version.

``conv_transpose3d(x, kernel, bias, stride, padding, output_padding)`` is
torch's transposed conv (one group, dilation 1) on the port's layouts: an
NDHWC activation, a DHWIO kernel (I = the transposed op's input channels,
no flip) and NDHWC out. It replaces no TPU kernel (the JAX package left
these convs to XLA). On the card it runs the decoder's transposed layers'
forward (``ConvTranspose3d``) and every direct conv's input gradient
(``Conv3d``: the transposed conv of the output gradient), both of which
cuDNN ran as ``dgrad2d_grouped_direct_kernel`` at about 0.2% of the card's
f32 FFMA rate. ``Conv3d``'s f32 forward is the direct conv kernel
(``kernels/conv3d.py``).

- A CUDA tensor goes to the hand-written kernel ``csrc/conv_transpose.cu``
  (one launch: a phase-split gather; see the source for the design),
  built into the port's kernel library at first use (``kernels/build.py``)
  and bound with ``ctypes``. f32 and bf16 operands; the sum is f32 and
  rounded once; an f32 bias is added in the kernel's epilogue. Every other
  pass (the transposed convs' backward, the direct convs' bf16 forward and
  weight gradient) stays cuDNN, through ``aten.convolution`` and
  ``aten.convolution_backward`` on the operands and memory formats that
  ``F.conv*``'s autograd uses, so its kernels and bits are the ones
  autograd ran before. A shape or dtype the kernel does not take raises;
  there is no fallback.
- A CPU tensor goes to ``conv_transpose3d_ref``, the plain PyTorch version,
  which repeats the kernel's index arithmetic from the same phase tables.

``LAUNCHES`` counts the wrapper's kernel runs (one per launch on a CUDA
tensor; inside a CUDA graph only the capture counts), so a caller can show
that a path went through the kernel.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from nvfpcc_tpu_torch.kernels import conv3d
from nvfpcc_tpu_torch.kernels.build import error_string, load_library

MAX_EDGE = 128  # largest output edge along an axis (the kernel's table size)
BOX_MAX = 8  # sub-grid positions of a CTA's box along an axis (at most 512 threads)
SMEM_BUDGET = 100 * 1024  # bytes a CTA stages: two CTAs fit an SM
MIN_WAVES = 2  # CTAs a launch aims at, per SM, before it splits the phase classes

LAUNCHES = 0


def phase_tables(n_in: int, k: int, stride: int, padding: int, output_padding: int) -> np.ndarray:
    """Per output ``o`` of one axis (columns): the first tap ``t0 = (o +
    padding) mod stride``, the input ``ib`` that tap meets, and the range
    ``[jlo, jhi)`` of ``j`` for which tap ``t0 + stride * j`` (< k) meets
    input ``ib - j`` inside ``[0, n_in)``. Rows t0, ib, jlo, jhi; int64."""
    if min(n_in, k, stride) < 1 or padding < 0 or output_padding < 0:
        raise ValueError(f"bad transposed conv axis: n_in {n_in}, k {k}, stride {stride}, "
                         f"padding {padding}, output_padding {output_padding}")
    n_out = (n_in - 1) * stride - 2 * padding + k + output_padding
    if n_out < 1:
        raise ValueError(f"transposed conv axis of {n_in} inputs gives {n_out} outputs")
    o = np.arange(n_out)
    t0 = (o + padding) % stride
    ib = (o + padding - t0) // stride
    taps = -(-(k - t0) // stride)  # taps t0 + stride * j below k
    jlo = np.maximum(0, ib - n_in + 1)
    jhi = np.maximum(jlo, np.minimum(taps, ib + 1))
    return np.stack([t0, ib, jlo, jhi])


def useful_macs(in_shape, cin: int, cout: int, k: int, stride: int, padding: int,
                output_padding: int) -> int:
    """Multiply-adds of one block's transposed conv that meet an input voxel:
    the kernel's count, from the phase tables."""
    per_axis = [int((t[3] - t[2]).sum()) for t in
                (phase_tables(e, k, stride, padding, output_padding) for e in in_shape)]
    return int(np.prod(per_axis)) * cin * cout


@functools.lru_cache(maxsize=64)
def _geometry(in_shape, cin: int, cout: int, k: int, stride: int, padding: int, output_padding: int):
    """(out edges, axes int32 (3, 6), tables int16 (3, 4, MAX_EDGE), cic, cot,
    boxes) of a layer: everything of a launch but the batch."""
    axes = np.zeros((3, 6), np.int32)
    tables = np.zeros((3, 4, MAX_EDGE), np.int16)
    out_shape = []
    for a, n_in in enumerate(in_shape):
        tab = phase_tables(n_in, k, stride, padding, output_padding)
        n_out = tab.shape[1]
        if n_out > MAX_EDGE:
            raise ValueError(f"transposed conv output edge {n_out} > {MAX_EDGE}")
        m = -(-n_out // stride)  # the largest phase class's sub-grid edge
        nbox = -(-m // BOX_MAX)
        box = -(-m // nbox)
        lo = -((k - 1 - padding) // stride)  # ceil((padding - k + 1) / stride)
        halo = box - lo + (stride - 1 + padding) // stride
        axes[a] = (n_in, n_out, box, nbox, lo, halo)
        tables[a, :, :n_out] = tab
        out_shape.append(n_out)
    plane = int(np.prod(axes[:, 5]))
    cot = 4 if cout <= 4 else 8 if cout <= 8 else 16
    cic = cin
    while cic > 1 and 4 * (k**3 * cic * cot + plane * cic) + tables.nbytes > SMEM_BUDGET:
        cic -= 1
    if 4 * (k**3 * cic * cot + plane * cic) + tables.nbytes > SMEM_BUDGET:
        raise ValueError(f"transposed conv k{k}: one input channel's halo and weights exceed "
                         f"{SMEM_BUDGET} bytes of shared memory")
    return tuple(out_shape), axes, tables, cic, cot, int(np.prod(axes[:, 3]))


def phase_groups(n: int, boxes: int, cout_tiles: int, stride: int, sm_count: int) -> int:
    """grid.z: how many CTAs share a box's phase classes. 1 while the batch's
    boxes alone give ``MIN_WAVES`` CTAs per SM; doubled until they do, up
    to one phase class a CTA."""
    g, nph = 1, stride**3
    while n * boxes * cout_tiles * g < MIN_WAVES * sm_count and g < nph:
        g *= 2
    return min(g, nph)


def launch(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int, padding: int,
           output_padding: int) -> torch.Tensor:
    """One kernel run on the card (no autograd): contiguous NDHWC ``x`` and
    DHWIO ``kernel`` of one dtype (f32 or bf16), an f32 ``bias`` (f32 only)
    or None; returns NDHWC in ``x``'s dtype."""
    global LAUNCHES
    conv3d.check_operands(x, kernel, bias)
    if x.device.type != "cuda" or kernel.device != x.device:
        raise ValueError(f"the transposed conv kernel needs CUDA tensors, got {x.device}, {kernel.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or kernel.dtype != x.dtype:
        raise TypeError(f"x and kernel must both be float32 or bfloat16, got {x.dtype}, {kernel.dtype}")
    if bias is not None and (x.dtype != torch.float32 or bias.dtype != torch.float32
                             or bias.device != x.device):
        raise TypeError("a fused bias needs f32 operands and an f32 bias on x's device")
    if not (x.is_contiguous() and kernel.is_contiguous() and (bias is None or bias.is_contiguous())):
        raise ValueError("x, kernel and bias must be contiguous")
    n, cin, cout, k = x.shape[0], x.shape[4], kernel.shape[4], kernel.shape[0]
    out_shape, axes, tables, cic, cot, boxes = _geometry(
        tuple(x.shape[1:4]), cin, cout, k, stride, padding, output_padding)
    cout_tiles = -(-cout // cot)
    groups = phase_groups(n, boxes, cout_tiles, stride,
                          torch.cuda.get_device_properties(x.device).multi_processor_count)
    out = torch.empty((n, *out_shape, cout), dtype=x.dtype, device=x.device)
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.nvfpcc_conv_transpose3d(
            x.data_ptr(), kernel.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), n, cin, cout, k, stride, padding, axes.ctypes.data,
            tables.ctypes.data, cic, cot, groups, stream)
    if rc != 0:
        raise RuntimeError(f"transposed conv kernel launch failed: {error_string(rc)}")
    LAUNCHES += 1
    return out


class ConvTranspose3d(torch.autograd.Function):
    """The kernel's forward; cuDNN's backward as ``F.conv_transpose3d``'s
    autograd runs it (``aten.convolution_backward``, transposed, on the
    same NCDHW views of the NDHWC operands), with only the gradients asked
    for."""

    @staticmethod
    def forward(ctx, x, kernel, bias, stride: int, padding: int, output_padding: int):
        ctx.save_for_backward(x, kernel)
        ctx.conv = (stride, padding, output_padding, None if bias is None else [bias.shape[0]])
        return launch(x, kernel, bias, stride, padding, output_padding)

    @staticmethod
    def backward(ctx, grad):
        x, kernel = ctx.saved_tensors
        stride, padding, output_padding, bias_sizes = ctx.conv
        mask = [bool(m) for m in ctx.needs_input_grad[:3]]
        gx, gw, gb = torch.ops.aten.convolution_backward(
            grad.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), kernel.permute(3, 4, 0, 1, 2),
            bias_sizes, [stride] * 3, [padding] * 3, [1] * 3, True, [output_padding] * 3, 1, mask)
        return (None if gx is None else gx.permute(0, 2, 3, 4, 1),
                None if gw is None else gw.permute(2, 3, 4, 0, 1), gb, None, None, None)


class Conv3d(torch.autograd.Function):
    """A direct conv whose data gradient is the kernel: an f32 forward is
    the direct conv kernel (``kernels/conv3d.py``, stride 1; it raises on
    any other), any other dtype's cuDNN (``aten.convolution`` on the NCDHW
    views, as ``F.conv3d``'s autograd runs it); cuDNN runs the weight and
    bias gradients (``aten.convolution_backward``); the input gradient is
    the transposed conv of the output gradient with the kernel's I and O
    swapped, at the same stride and padding, and the output padding that
    gives back the input's edge."""

    @staticmethod
    def forward(ctx, x, kernel, bias, stride: int, padding: int):
        ctx.save_for_backward(x, kernel)
        ctx.conv = (stride, padding, None if bias is None else [bias.shape[0]])
        if x.dtype == torch.float32:
            return conv3d.launch(x.contiguous(), kernel.contiguous(), bias, stride, padding)
        y = torch.ops.aten.convolution(x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2), bias,
                                       [stride] * 3, [padding] * 3, [1] * 3, False, [0] * 3, 1)
        return y.permute(0, 2, 3, 4, 1)

    @staticmethod
    def backward(ctx, grad):
        x, kernel = ctx.saved_tensors
        stride, padding, bias_sizes = ctx.conv
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            k = kernel.shape[0]
            out_pad = [e - ((g - 1) * stride - 2 * padding + k) for e, g in zip(x.shape[1:4], grad.shape[1:4])]
            if len(set(out_pad)) != 1:
                raise ValueError(f"conv data gradient: unequal output padding {out_pad}")
            gx = launch(grad.contiguous(), kernel.transpose(3, 4).contiguous(), None, stride, padding,
                        out_pad[0])
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            _, gw, gb = torch.ops.aten.convolution_backward(
                grad.permute(0, 4, 1, 2, 3), x.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2),
                bias_sizes, [stride] * 3, [padding] * 3, [1] * 3, False, [0] * 3, 1,
                [False, bool(ctx.needs_input_grad[1]), bool(ctx.needs_input_grad[2])])
            gw = None if gw is None else gw.permute(2, 3, 4, 1, 0)
        return gx, gw, gb, None, None


def conv_transpose3d(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int, padding: int,
                     output_padding: int) -> torch.Tensor:
    """The transposed conv: the kernel (with autograd) for a CUDA tensor,
    the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return conv_transpose3d_ref(x, kernel, bias, stride, padding, output_padding)
    return ConvTranspose3d.apply(x.contiguous(), kernel.contiguous(), bias, stride, padding, output_padding)


def conv_transpose3d_ref(x: torch.Tensor, kernel: torch.Tensor, bias, stride: int, padding: int,
                         output_padding: int) -> torch.Tensor:
    """Plain PyTorch version, on any device: for each phase class and each
    (j_d, j_h, j_w), gather the inputs the phase tables name, mask the taps
    that meet no input, and contract over Cin; f32 sums (bf16 operands
    widened), the bias added in f32, rounded once to ``x``'s dtype."""
    conv3d.check_operands(x, kernel, bias)
    n, cin, cout, k, s = x.shape[0], x.shape[4], kernel.shape[4], kernel.shape[0], stride
    tabs = [torch.from_numpy(phase_tables(e, k, s, padding, output_padding)).to(x.device)
            for e in x.shape[1:4]]
    xf, wf = x.float(), kernel.float()
    out = torch.zeros((n, *[t.shape[1] for t in tabs], cout), dtype=torch.float32, device=x.device)
    for q in itertools.product(range(s), repeat=3):
        sub = [t[:, qa::s] for t, qa in zip(tabs, q)]  # the phase class's outputs per axis
        if any(t.shape[1] == 0 for t in sub):
            continue
        acc = out[:, q[0]::s, q[1]::s, q[2]::s]
        for js in itertools.product(range(-(-k // s)), repeat=3):
            valid = [(t[2] <= j) & (j < t[3]) for t, j in zip(sub, js)]
            if not all(bool(v.any()) for v in valid):
                continue
            idx = [(t[1] - j).clamp(0, e - 1) for t, j, e in zip(sub, js, x.shape[1:4])]
            taps = [int(t[0, 0]) + s * j for t, j in zip(sub, js)]
            g = xf[:, idx[0]][:, :, idx[1]][:, :, :, idx[2]]
            m = valid[0][:, None, None] & valid[1][None, :, None] & valid[2][None, None, :]
            acc += torch.einsum("ndhwc,co->ndhwo", g * m[None, ..., None], wf[taps[0], taps[1], taps[2]])
    if bias is not None:
        out += bias.float()
    return out.to(x.dtype)
