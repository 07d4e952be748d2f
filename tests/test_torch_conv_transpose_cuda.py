"""The transposed conv kernel (``csrc/conv_transpose.cu``) on the card.

Marked ``cuda``: the kernel has no CPU mode, so these skip without a card.
The file imports no jax; run it as ``test_torch_edt_cuda.py`` is run:

    python -m pytest tests/test_torch_conv_transpose_cuda.py -m cuda --noconftest -o "markers=cuda: needs a CUDA card" -p no:cacheprovider

Against cuDNN with deterministic algorithms and TF32 off. Bounds: f32,
2e-5 of the output's largest magnitude (f32 sums of at most a few hundred
terms in another order: n * eps is 2.6e-5 of the terms' sum at 432 terms);
bf16, one bf16 ulp (2^-7) of the largest magnitude (both sides round an f32
sum to bf16 once, so they part by at most one ulp of a value).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nvfpcc_tpu_torch.kernels import conv3d as C3
from nvfpcc_tpu_torch.kernels import conv_transpose as CT

F32_BOUND = 2e-5
BF16_BOUND = 2.0**-7

# the decoder's transposed layers at the flagship width: (layer, input
# edge, Cin, Cout, padding, output_padding)
LAYERS = [("up0", 2, 3, 8, 2, 1), ("conv0", 4, 8, 16, 2, 1), ("up1", 8, 16, 8, 0, 0), ("up2", 16, 8, 8, 0, 0)]
# direct convs whose input gradient runs through the kernel: (layer, input edge, Cin, Cout, k, padding)
DIRECT = [("conv1", 19, 8, 8, 4, 0), ("conv2", 35, 8, 8, 4, 0), ("conv2_cls", 32, 8, 1, 3, 1),
          ("latent_gen", 2, 3, 3, 1, 0)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _operands(dev, n, edge, cin, cout, dtype, k=5, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, edge, edge, edge, cin), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, k, k, cin, cout), generator=g, device=dev) * 0.1).to(dtype)
    b = torch.randn((cout,), generator=g, device=dev)
    return x, w, b


def _cudnn(x, w, b, pad, opad):
    return F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w.permute(3, 4, 0, 1, 2), b, 2, pad, opad).permute(0, 2, 3, 4, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layer", [c[0] for c in LAYERS])
def test_kernel_matches_cudnn_and_plain(layer, dtype, card):
    _, edge, cin, cout, pad, opad = next(c for c in LAYERS if c[0] == layer)
    cd = torch.float32 if dtype == "f32" else torch.bfloat16
    x, w, b = _operands(card, 6, edge, cin, cout, cd)
    bias = b if dtype == "f32" else None
    before = CT.LAUNCHES
    got = CT.launch(x, w, bias, 2, pad, opad)
    torch.cuda.synchronize()
    assert CT.LAUNCHES == before + 1
    want = _cudnn(x, w, bias, pad, opad)
    plain = CT.conv_transpose3d_ref(x, w, bias, 2, pad, opad)
    assert got.dtype == cd and got.shape == want.shape and got.is_contiguous()
    bound = (F32_BOUND if dtype == "f32" else BF16_BOUND) * want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= bound
    assert (got.float() - plain.float()).abs().max() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["up1", "up2"])
def test_a_block_is_the_same_bits_in_any_batch(layer, card):
    _, edge, cin, cout, pad, opad = next(c for c in LAYERS if c[0] == layer)
    for cd, bias_on in ((torch.float32, True), (torch.bfloat16, False)):
        x, w, b = _operands(card, 128, edge, cin, cout, cd, seed=1)
        bias = b if bias_on else None
        full = CT.launch(x, w, bias, 2, pad, opad)
        again = CT.launch(x, w, bias, 2, pad, opad)
        assert torch.equal(full, again)
        for n in (1, 16):
            part = CT.launch(x[:n].contiguous(), w, bias, 2, pad, opad)
            assert torch.equal(part, full[:n])
        # block 77 alone, and at the front of a batch of 16
        alone = CT.launch(x[77:78].contiguous(), w, bias, 2, pad, opad)
        assert torch.equal(alone[0], full[77])
        mixed = torch.cat([x[77:78], x[:15]]).contiguous()
        assert torch.equal(CT.launch(mixed, w, bias, 2, pad, opad)[0], full[77])


@pytest.mark.cuda
def test_graph_replay_is_the_eager_bits(card):
    _, edge, cin, cout, pad, opad = LAYERS[3]
    x, w, b = _operands(card, 16, edge, cin, cout, torch.float32, seed=2)
    eager = CT.launch(x, w, b, 2, pad, opad)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        CT.launch(x, w, b, 2, pad, opad)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = CT.LAUNCHES
    with torch.cuda.graph(graph, stream=stream):
        out = CT.launch(x, w, b, 2, pad, opad)
    assert CT.LAUNCHES == before + 1  # counted at the capture
    x2, _, _ = _operands(card, 16, edge, cin, cout, torch.float32, seed=3)
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert CT.LAUNCHES == before + 1  # a replay launches without the wrapper
    assert torch.equal(out, CT.launch(x2, w, b, 2, pad, opad))
    x.copy_(_operands(card, 16, edge, cin, cout, torch.float32, seed=2)[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("needs", ["all", "input_only"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layer", ["conv0", "up2"])
def test_gradients_are_autograds_bits(layer, dtype, needs, card):
    """The Function's backward is cuDNN's, as ``F.conv_transpose3d``'s
    autograd runs it: the same gradients bit for bit for the same grad_out."""
    _, edge, cin, cout, pad, opad = next(c for c in LAYERS if c[0] == layer)
    cd = torch.float32 if dtype == "f32" else torch.bfloat16
    x, w, b = _operands(card, 4, edge, cin, cout, cd, seed=4)
    bias = b if dtype == "f32" else None
    x.requires_grad_(True)
    w.requires_grad_(needs == "all")
    if bias is not None:
        bias.requires_grad_(needs == "all")
    leaves = [t for t in (x, w, bias) if t is not None and t.requires_grad]
    y = CT.conv_transpose3d(x, w, bias, 2, pad, opad)
    gy = torch.randn(y.shape, device=card, generator=torch.Generator(device=card).manual_seed(5)).to(cd)
    got = torch.autograd.grad(y, leaves, gy)
    want = torch.autograd.grad(_cudnn(x, w, bias, pad, opad), leaves, gy)
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and torch.equal(a, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("layer", [c[0] for c in DIRECT])
def test_direct_conv_input_gradient(layer, dtype, card):
    """``Conv3d``: the forward, the direct conv kernel's bits in f32 (within
    the bound of cuDNN's) and cuDNN's bits in bf16; cuDNN's weight and bias
    gradients bit for bit; the input gradient from the kernel within the
    bounds of cuDNN's."""
    _, edge, cin, cout, k, pad = next(c for c in DIRECT if c[0] == layer)
    cd = torch.float32 if dtype == "f32" else torch.bfloat16
    x, w, b = _operands(card, 4, edge, cin, cout, cd, k=k, seed=6)
    bias = b.requires_grad_(True) if dtype == "f32" else None
    x.requires_grad_(True)
    w.requires_grad_(True)
    leaves = [t for t in (x, w, bias) if t is not None]
    y = CT.Conv3d.apply(x, w, bias, 1, pad)
    yr = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), bias, 1, pad).permute(0, 2, 3, 4, 1)
    if dtype == "f32":
        assert torch.equal(y, C3.launch(x.detach(), w.detach(), bias.detach(), 1, pad))
        assert (y - yr).abs().max() <= F32_BOUND * yr.abs().max()
    else:
        assert torch.equal(y, yr)
    gy = torch.randn(y.shape, device=card, generator=torch.Generator(device=card).manual_seed(7)).to(cd)
    before = CT.LAUNCHES
    got = torch.autograd.grad(y, leaves, gy)
    assert CT.LAUNCHES == before + 1
    want = torch.autograd.grad(yr, leaves, gy)
    bound = (F32_BOUND if dtype == "f32" else BF16_BOUND) * want[0].float().abs().max()
    assert got[0].dtype == cd and (got[0].float() - want[0].float()).abs().max() <= bound
    for a, r in zip(got[1:], want[1:]):
        assert torch.equal(a, r)


@pytest.mark.cuda
def test_refusals(card):
    x, w, b = _operands(card, 2, 8, 16, 8, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        CT.launch(x.half(), w.half(), None, 2, 0, 0)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        CT.launch(x, w.to(torch.bfloat16), None, 2, 0, 0)
    with pytest.raises(TypeError, match="fused bias"):
        CT.launch(x.to(torch.bfloat16), w.to(torch.bfloat16), b, 2, 0, 0)
    with pytest.raises(ValueError, match="contiguous"):
        CT.launch(x.transpose(1, 2), w, b, 2, 0, 0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        CT.launch(x.cpu(), w.cpu(), None, 2, 0, 0)
    with pytest.raises(ValueError, match="does not fit"):
        CT.launch(x, w[:, :, :, :8].contiguous(), None, 2, 0, 0)
    big = torch.zeros((1, 70, 70, 70, 2), device=card)
    with pytest.raises(ValueError, match="output edge"):
        CT.launch(big, torch.zeros((5, 5, 5, 2, 2), device=card), None, 2, 0, 0)
    assert np.isfinite(CT.launch(x, w, b, 2, 0, 0).cpu().numpy()).all()
