"""The transposed conv kernel's CPU side (``kernels/conv_transpose.py``):
the plain version, which repeats the kernel's phase-table index arithmetic,
held against ``F.conv_transpose3d`` and the JAX package's
``qconv_transpose3d`` at the decoder's transposed layer shapes; the phase
tables' multiply-add count against ``benchmark/counters.taps_1d``'s rule;
the CPU route (no launch, bits of ``F.conv_transpose3d``); the launch plan;
and the two autograd Functions' backward with the plain version in the
kernel's place. The kernel itself runs on the card
(``test_torch_conv_transpose_cuda.py``).

Tolerances: f32 sums in another order, 2e-6 of the output's largest
magnitude (about 30 ulps at a few hundred terms); bf16 operands with an f32
sum rounded once, one bf16 ulp (2^-8 relative) of the largest magnitude
against torch and two against JAX (which rounds its bf16 conv elsewhere).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.counters import taps_1d
from nvfpcc_tpu.ops import conv as jconv
from nvfpcc_tpu.utils import seeds
from nvfpcc_tpu_torch.kernels import conv3d as C3
from nvfpcc_tpu_torch.kernels import conv_transpose as CT
from nvfpcc_tpu_torch.ops import conv as tconv

F32_TOL = 2e-6
BF16_ULP = 2.0**-8

# the decoder's transposed layers: (layer, input edge, in index, out index,
# padding, output_padding) over the channel plan (ch, c0, c1, c2, c3)
LAYERS = [("up0", 2, 0, 1, 2, 1), ("conv0", 4, 1, 2, 2, 1), ("up1", 8, 2, 3, 0, 0), ("up2", 16, 3, 4, 0, 0)]
WIDTHS = {"flagship": (3, 8, 16, 8, 8), "toy": (3, 4, 8, 4, 4)}
OUT_EDGE = {"up0": 4, "conv0": 8, "up1": 19, "up2": 35}


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layer_case(layer, width, q_seed=0):
    name, edge, i, o, pad, opad = next(c for c in LAYERS if c[0] == layer)
    chans = WIDTHS[width]
    key = seeds.layer_key(seeds.base_key(), 5)
    jspec = jconv.make_qspec(key, "conv_transpose", chans[i], chans[o], 5, 2, pad, output_padding=opad)
    rng = np.random.default_rng(q_seed)
    x = rng.normal(0, 1, (1, edge, edge, edge, chans[i])).astype(np.float32)
    resid = rng.normal(0, 0.05, jspec.kernel_shape).astype(np.float32)
    b = rng.normal(0, 0.1, chans[o]).astype(np.float32)
    return jspec, x, resid, b, pad, opad


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("layer", [c[0] for c in LAYERS])
def test_plain_version_matches_torch_and_jax(layer, width, dtype, one_thread):
    jspec, x, resid, b, pad, opad = _layer_case(layer, width)
    tspec = tconv.make_qspec(seeds.layer_key(seeds.base_key(), 5), "conv_transpose", jspec.in_ch, jspec.out_ch,
                             5, 2, pad, output_padding=opad)
    mod = tconv.QConvTranspose3d(tspec)
    with torch.no_grad():
        mod.kernel.copy_(torch.from_numpy(resid))
        mod.b.copy_(torch.from_numpy(b))
        kernel, bias = mod.effective_kernel(2), mod.effective_bias()
    cd = torch.float32 if dtype == "f32" else torch.bfloat16
    xt, kt = torch.from_numpy(x).to(cd), kernel.to(cd)
    jparams = {"kernel": jnp.asarray(resid), "b": jnp.asarray(b)}
    if dtype == "f32":
        got = CT.conv_transpose3d_ref(xt, kt, bias, 2, pad, opad)
        want = F.conv_transpose3d(xt.permute(0, 4, 1, 2, 3), kt.permute(3, 4, 0, 1, 2), bias, 2, pad, opad)
        want = want.permute(0, 2, 3, 4, 1)
        jwant = np.asarray(jconv.qconv_transpose3d(jspec, jparams, jnp.asarray(x), 2))
        tol = F32_TOL
    else:
        got = (CT.conv_transpose3d_ref(xt, kt, None, 2, pad, opad) + bias.to(cd)).float()
        conv = F.conv_transpose3d(xt.float().permute(0, 4, 1, 2, 3), kt.float().permute(3, 4, 0, 1, 2), None,
                                  2, pad, opad)
        want = conv.permute(0, 2, 3, 4, 1).to(cd) + bias.to(cd)
        jwant = np.asarray(jconv.qconv_transpose3d(jspec, jparams, jnp.asarray(x), 2, None, "bf16").astype(jnp.float32))
        tol = BF16_ULP
    want = want.float().numpy()
    got = got.float().numpy()
    assert got.shape == want.shape == jwant.shape == (1, *(OUT_EDGE[layer],) * 3, jspec.out_ch)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= tol * scale
    assert np.abs(got - jwant).max() <= (1 if dtype == "f32" else 2) * tol * scale


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("layer", [c[0] for c in LAYERS])
def test_phase_tables_count_the_useful_macs(layer, width):
    name, edge, i, o, pad, opad = next(c for c in LAYERS if c[0] == layer)
    cin, cout = WIDTHS[width][i], WIDTHS[width][o]
    n_out, pairs = taps_1d("conv_transpose", edge, 5, 2, pad, opad)
    tab = CT.phase_tables(edge, 5, 2, pad, opad)
    assert tab.shape == (4, n_out) and n_out == OUT_EDGE[layer]
    assert CT.useful_macs((edge,) * 3, cin, cout, 5, 2, pad, opad) == pairs**3 * cin * cout
    t0, ib, jlo, jhi = tab
    # each listed tap meets an input inside the grid, and no other tap does
    for o_ in range(n_out):
        met = {(t0[o_] + 2 * j, ib[o_] - j) for j in range(jlo[o_], jhi[o_])}
        want = {(t, (o_ + pad - t) // 2) for t in range(5)
                if (o_ + pad - t) % 2 == 0 and 0 <= (o_ + pad - t) // 2 < edge}
        assert met == want


def test_cpu_route_is_f_conv_transpose3d_and_launches_nothing(one_thread):
    rng = np.random.default_rng(4)
    before = CT.LAUNCHES
    for name, edge, i, o, pad, opad in LAYERS:
        cin, cout = WIDTHS["flagship"][i], WIDTHS["flagship"][o]
        x = torch.from_numpy(rng.normal(0, 1, (2, edge, edge, edge, cin)).astype(np.float32))
        k = torch.from_numpy(rng.normal(0, 0.1, (5, 5, 5, cin, cout)).astype(np.float32))
        b = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
        for cd in (None, "bf16"):
            got = tconv.conv_transpose3d_ndhwc(x, k, b, 2, pad, opad, cd)
            c = torch.float32 if cd is None else torch.bfloat16
            xv, wv = x.permute(0, 4, 1, 2, 3).to(c), k.permute(3, 4, 0, 1, 2).to(c)
            if cd is None:
                want = F.conv_transpose3d(xv, wv, b, 2, pad, opad).permute(0, 2, 3, 4, 1)
            else:
                want = F.conv_transpose3d(xv, wv, None, 2, pad, opad).permute(0, 2, 3, 4, 1) + b.to(c)
            assert got.dtype == want.dtype and torch.equal(got, want)
        # the plain route of the kernel module is the plain version
        assert torch.equal(CT.conv_transpose3d(x, k, b, 2, pad, opad), CT.conv_transpose3d_ref(x, k, b, 2, pad, opad))
    assert CT.LAUNCHES == before


@pytest.mark.parametrize("shape,cin,cout,k,stride,pad,opad,want", [
    # the flagship's up2 and up1: one phase group, whole channel plans staged
    ((16, 16, 16), 8, 8, 5, 2, 0, 0, dict(out=(35, 35, 35), box=6, nbox=3, cic=8, cot=8)),
    ((8, 8, 8), 16, 8, 5, 2, 0, 0, dict(out=(19, 19, 19), box=5, nbox=2, cic=16, cot=8)),
    # conv2's input gradient: stride 1, k4, 32 -> 35
    ((32, 32, 32), 8, 8, 4, 1, 0, 0, dict(out=(35, 35, 35), box=7, nbox=5, cic=8, cot=8)),
    # wide channels: Cout tiles of 16, Cin in chunks under the budget
    ((8, 8, 8), 64, 40, 5, 2, 0, 0, dict(out=(19, 19, 19), box=5, nbox=2, cic=10, cot=16)),
])
def test_launch_plan(shape, cin, cout, k, stride, pad, opad, want):
    out, axes, tables, cic, cot, boxes = CT._geometry(shape, cin, cout, k, stride, pad, opad)
    assert out == want["out"] and (cic, cot) == (want["cic"], want["cot"])
    assert (axes[:, 2] == want["box"]).all() and (axes[:, 3] == want["nbox"]).all() and boxes == want["nbox"] ** 3
    assert 4 * (k**3 * cic * cot + int(np.prod(axes[:, 5])) * cic) + tables.nbytes <= CT.SMEM_BUDGET
    # a box's halo holds every input its outputs meet
    for a, n_in in enumerate(shape):
        n_in_, n_out, box, nbox, lo, halo = axes[a]
        t0, ib, jlo, jhi = tables[a, :, :n_out].astype(np.int64)
        for o in range(n_out):
            b = (o // stride) // box
            for j in range(jlo[o], jhi[o]):
                assert 0 <= ib[o] - j - (b * box + lo) < halo


def test_phase_groups_split_small_batches_only():
    assert CT.phase_groups(128, 27, 1, 2, 132) == 1
    assert CT.phase_groups(16, 8, 1, 2, 132) == 4  # up1 at the net step's batch
    assert CT.phase_groups(1, 1, 1, 2, 132) == 8
    assert CT.phase_groups(1, 1, 1, 1, 132) == 1  # stride 1: one phase class


def test_unsupported_shapes_raise():
    with pytest.raises(ValueError, match="output edge"):
        CT._geometry((70, 70, 70), 8, 8, 5, 2, 0, 0)
    with pytest.raises(ValueError, match="shared memory"):
        CT._geometry((8, 8, 8), 4, 8, 17, 2, 0, 0)
    with pytest.raises(ValueError, match="does not fit"):
        CT.conv_transpose3d_ref(torch.zeros(1, 2, 2, 2, 3), torch.zeros(5, 5, 5, 4, 8), None, 2, 0, 0)


@pytest.mark.parametrize("case", ["transposed", "conv_s1", "conv_s1_same", "conv_s2"])
@pytest.mark.parametrize("needs", ["all", "input_only", "weight_only"])
def test_functions_backward_with_plain_kernel(case, needs, monkeypatch, one_thread):
    """The Functions' backward, with the plain versions in the kernels'
    places (the direct conv's f32 forward runs one): weight and bias
    gradients bit-equal to ``F.conv*``'s autograd (the same
    ``convolution_backward`` call), the input gradient of the direct conv
    (the kernel's transposed conv) within f32 round-off of cuDNN's."""
    monkeypatch.setattr(CT, "launch", CT.conv_transpose3d_ref)
    forwards = []
    monkeypatch.setattr(C3, "launch", lambda *a: forwards.append(a) or C3.conv3d_ref(*a))
    g = torch.Generator().manual_seed(7)
    if case == "transposed":
        x, w = torch.randn(2, 4, 4, 4, 8, generator=g), torch.randn(5, 5, 5, 8, 6, generator=g)
        fn = lambda x, w, b: CT.ConvTranspose3d.apply(x, w, b, 2, 2, 1)
        ref = lambda x, w, b: F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w.permute(3, 4, 0, 1, 2), b, 2, 2, 1)
    else:
        stride, pad = {"conv_s1": (1, 0), "conv_s1_same": (1, 1), "conv_s2": (2, 1)}[case]
        x, w = torch.randn(2, 7, 7, 7, 8, generator=g), torch.randn(4, 4, 4, 8, 6, generator=g)
        fn = lambda x, w, b: CT.Conv3d.apply(x, w, b, stride, pad)
        ref = lambda x, w, b: F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, stride, pad)
    b = torch.randn(6, generator=g)
    x.requires_grad_(needs != "weight_only")
    w.requires_grad_(needs != "input_only")
    b.requires_grad_(needs != "input_only")
    leaves = [t for t in (x, w, b) if t.requires_grad]
    y = fn(x, w, b)
    want_y = ref(x, w, b).permute(0, 2, 3, 4, 1)
    gy = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad(y, leaves, gy)
    want = torch.autograd.grad(want_y, leaves, gy)
    assert y.shape == want_y.shape and y.is_contiguous()
    assert len(forwards) == (case != "transposed")
    assert (y - want_y).abs().max() <= F32_TOL * want_y.abs().max()
    for t, a, r in zip(leaves, got, want):
        assert a.shape == t.shape
        if t is x and case != "transposed":
            assert (a - r).abs().max() <= F32_TOL * 10 * r.abs().max()
        else:
            assert torch.equal(a, r)
