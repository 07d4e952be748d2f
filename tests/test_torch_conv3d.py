"""The direct conv kernel's CPU side (``kernels/conv3d.py``): the plain
version, which repeats the kernel's Cin chunks and summation order, held
against ``F.conv3d`` and the JAX package's ``qconv3d`` at the port's direct
layer shapes (toy widths); the launch plan; the refusals; the CPU route.
The kernel itself runs on the card (``test_torch_conv3d_cuda.py``); the
autograd Function that calls it is held with the plain version in its place
in ``test_torch_conv_transpose.py``.

Tolerance: f32 sums in another order, 2e-6 of the output's largest
magnitude (about 30 ulps at a few hundred terms).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nvfpcc_tpu.ops import conv as jconv
from nvfpcc_tpu.utils import seeds
from nvfpcc_tpu_torch.kernels import conv3d as C3
from nvfpcc_tpu_torch.ops import conv as tconv

F32_TOL = 2e-6

# the port's direct layers at a toy width: (layer, blocks, input edge, Cin,
# Cout, k, padding, masked). ctx1 is ctx_ar's first masked conv (the
# channel-AR mask folded into the kernel).
LAYERS = [("conv1", 2, 19, 4, 4, 4, 0, False), ("conv2", 1, 35, 4, 4, 4, 0, False),
          ("conv2_cls", 2, 32, 4, 1, 3, 1, False), ("latent_gen", 3, 2, 3, 3, 1, 0, False),
          ("ctx1", 3, 2, 3, 8, 3, 1, True)]


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _specs(layer, cin, cout, k, pad, masked):
    key = seeds.layer_key(seeds.base_key(), 7)
    if not masked:
        return jconv.make_qspec(key, "conv", cin, cout, k, 1, pad), tconv.make_qspec(key, "conv", cin, cout, k, 1, pad)
    mask = tconv.channel_ar_mask(k, cin, cout, in_group=lambda i: i, out_group=lambda g: g % cin, center_strict=True)
    return (jconv.make_masked_qspec(key, cin, cout, k, mask=mask),
            tconv.make_masked_qspec(key, cin, cout, k, mask=mask))


@pytest.mark.parametrize("layer", [c[0] for c in LAYERS])
def test_plain_version_matches_torch_and_jax(layer, one_thread):
    _, n, edge, cin, cout, k, pad, masked = next(c for c in LAYERS if c[0] == layer)
    jspec, tspec = _specs(layer, cin, cout, k, pad, masked)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (n, edge, edge, edge, cin)).astype(np.float32)
    resid = rng.normal(0, 0.05, jspec.kernel_shape).astype(np.float32)
    b = rng.normal(0, 0.1, cout).astype(np.float32)
    mod = tconv.QConv3d(tspec)
    with torch.no_grad():
        mod.kernel.copy_(torch.from_numpy(resid))
        mod.b.copy_(torch.from_numpy(b))
        kernel, bias = mod.effective_kernel(2), mod.effective_bias()
    xt = torch.from_numpy(x)
    got = C3.conv3d_ref(xt, kernel, bias, 1, pad).numpy()
    want = F.conv3d(xt.permute(0, 4, 1, 2, 3), kernel.permute(4, 3, 0, 1, 2), bias, 1, pad)
    want = want.permute(0, 2, 3, 4, 1).numpy()
    jwant = np.asarray(jconv.qconv3d(jspec, {"kernel": jnp.asarray(resid), "b": jnp.asarray(b)}, jnp.asarray(x), 2))
    out_edge = edge + 2 * pad - k + 1
    assert got.shape == want.shape == jwant.shape == (n, out_edge, out_edge, out_edge, cout)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= F32_TOL * scale
    assert np.abs(got - jwant).max() <= F32_TOL * scale


@pytest.mark.parametrize("shape,cin,cout,k,pad,want", [
    # conv2, conv1, conv2_cls at the flagship width
    ((35, 35, 35), 8, 8, 4, 0, dict(variant=(4, 8, 8), tile=(1, 4, 8, 4), tiles=(8, 4, 1), cic=4, rs=36)),
    ((19, 19, 19), 8, 8, 4, 0, dict(variant=(4, 8, 8), tile=(1, 8, 8, 2), tiles=(2, 2, 1), cic=4, rs=20)),
    ((32, 32, 32), 8, 1, 3, 1, dict(variant=(3, 1, 8), tile=(1, 4, 8, 4), tiles=(8, 4, 1), cic=4, rs=36)),
    # the latent generator and ctx_post's second masked conv (hidden 32):
    # 16 blocks a CTA, their weights staged once
    ((2, 2, 2), 3, 3, 1, 0, dict(variant=(0, 4, 1), tile=(16, 2, 2, 2), tiles=(1, 1, 1), cic=3, rs=0)),
    ((2, 2, 2), 32, 6, 3, 1, dict(variant=(3, 4, 1), tile=(16, 2, 2, 2), tiles=(1, 1, 1), cic=32, rs=0)),
    # a wider channel plan's conv2, and an odd shape on the generic path
    ((35, 35, 35), 16, 16, 4, 0, dict(variant=(4, 8, 8), tile=(1, 4, 8, 4), tiles=(8, 4, 1), cic=4, rs=36)),
    ((9, 13, 40), 5, 3, 5, 2, dict(variant=(0, 4, 1), tile=(1, 4, 8, 4), tiles=(3, 2, 10), cic=5, rs=0)),
])
def test_launch_plan(shape, cin, cout, k, pad, want):
    p = C3.plan(shape, cin, cout, k, pad)
    kt, cot, r = p.variant
    tn, td, th, sw = p.tile
    assert p.out == tuple(e + 2 * pad - k + 1 for e in shape)
    assert (p.variant, p.tile, p.tiles, p.cic, p.halo[2]) == (want["variant"], want["tile"], want["tiles"],
                                                              want["cic"], want["rs"])
    assert tn * td * th * sw <= C3.MAX_THREADS and p.smem <= C3.SMEM_BUDGET
    if r > 1:  # the staged halo; a strip's float4 loads stay inside its row; rows 4 mod 8 floats apart
        assert p.halo[:2] == (td + k - 1, th + k - 1)
        assert p.halo[2] >= sw * r + -(-(k - 1) // 4) * 4 and p.halo[2] % 8 == 4
    else:  # one output a thread, its inputs read from device memory: weights alone staged
        assert p.halo == (0, 0, 0) and p.smem == 4 * k**3 * p.cic * cot
    # the tiles cover the output once; several blocks a CTA only where one tile covers a block
    assert all((t - 1) * e < o <= t * e for t, e, o in zip(p.tiles, (td, th, sw * r), p.out))
    assert tn == 1 or p.tiles == (1, 1, 1)


def test_refusals():
    x, w, b = torch.zeros(1, 6, 6, 6, 4), torch.zeros(3, 3, 3, 4, 8), torch.zeros(8)
    with pytest.raises(ValueError, match="stride 1 only"):
        C3.launch(x, w, b, 2, 1)
    for xd, wd, bd in ((torch.float64,) * 3, (torch.bfloat16,) * 3, (torch.float32, torch.bfloat16, torch.float32),
                       (torch.float32, torch.float32, torch.float16)):
        with pytest.raises(TypeError, match="float32"):
            C3.launch(x.to(xd), w.to(wd), b.to(bd), 1, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        C3.launch(x, w, b, 1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        C3.launch(x, w[:, :, :, :3].contiguous(), b, 1, 1)
    with pytest.raises(ValueError, match="does not fit"):
        C3.conv3d_ref(x, w, b[:4], 1, 1)
    with pytest.raises(ValueError, match="no output"):
        C3.plan((2, 2, 2), 4, 8, 4, 0)
    with pytest.raises(ValueError, match="shared memory"):
        C3.plan((20, 20, 20), 4, 8, 17, 0)


def test_cpu_route_is_f_conv3d_and_launches_nothing(one_thread):
    rng = np.random.default_rng(5)
    before = C3.LAUNCHES
    for _, n, edge, cin, cout, k, pad, _ in LAYERS:
        x = torch.from_numpy(rng.normal(0, 1, (n, edge, edge, edge, cin)).astype(np.float32))
        w = torch.from_numpy(rng.normal(0, 0.1, (k, k, k, cin, cout)).astype(np.float32))
        b = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32))
        want = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, 1, pad).permute(0, 2, 3, 4, 1)
        assert torch.equal(tconv.conv3d_ndhwc(x, w, b, 1, pad), want)
    assert C3.LAUNCHES == before
