"""The direct conv kernel (``csrc/conv3d.cu``) on the card.

Marked ``cuda``: the kernel has no CPU mode, so these skip without a card.
The file imports no jax; run it as ``test_torch_conv_transpose_cuda.py``
is run:

    python -m pytest tests/test_torch_conv3d_cuda.py -m cuda --noconftest -o "markers=cuda: needs a CUDA card" -p no:cacheprovider

Against cuDNN with deterministic algorithms and TF32 off, and against the
plain version. Bound: 2e-5 of the output's largest magnitude (f32 sums of
at most a few hundred terms in another order: n * eps is 2.6e-5 of the
terms' sum at 432 terms).
"""

import pytest
import torch
import torch.nn.functional as F

from nvfpcc_tpu_torch.kernels import conv3d as C3
from nvfpcc_tpu_torch.kernels import conv_transpose as CT

F32_BOUND = 2e-5

# every direct conv the port runs in f32, at the flagship width: (layer,
# input edge, Cin, Cout, k, padding); then a wider channel plan's conv2 and
# a shape only the generic path takes
DIRECT = [("conv1", 19, 8, 8, 4, 0), ("conv2", 35, 8, 8, 4, 0), ("conv2_cls", 32, 8, 1, 3, 1),
          ("conv1_cls", 16, 8, 1, 3, 1), ("conv0_cls", 8, 16, 1, 3, 1), ("latent_gen", 2, 3, 3, 1, 0),
          ("ctx1", 2, 3, 32, 3, 1), ("ctx2", 2, 32, 6, 3, 1), ("conv2_wide", 35, 16, 16, 4, 0),
          ("k5_generic", 11, 5, 3, 5, 2)]


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


def _operands(dev, n, layer, seed=0, dtype=torch.float32):
    _, edge, cin, cout, k, pad = next(c for c in DIRECT if c[0] == layer)
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n, edge, edge, edge, cin), generator=g, device=dev).to(dtype)
    w = (torch.randn((k, k, k, cin, cout), generator=g, device=dev) * 0.1).to(dtype)
    b = torch.randn((cout,), generator=g, device=dev)
    return x, w, b, pad


def _cudnn(x, w, b, pad):
    return F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, 1, pad).permute(0, 2, 3, 4, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bias_on", [True, False])
@pytest.mark.parametrize("layer", [c[0] for c in DIRECT])
def test_kernel_matches_cudnn_and_plain(layer, bias_on, card):
    x, w, b, pad = _operands(card, 5, layer)
    bias = b if bias_on else None
    before = C3.LAUNCHES
    got = C3.launch(x, w, bias, 1, pad)
    torch.cuda.synchronize()
    assert C3.LAUNCHES == before + 1
    want, plain = _cudnn(x, w, bias, pad), C3.conv3d_ref(x, w, bias, 1, pad)
    assert got.dtype == torch.float32 and got.shape == want.shape and got.is_contiguous()
    bound = F32_BOUND * want.abs().max()
    assert (got - want).abs().max() <= bound
    assert (got - plain).abs().max() <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["conv1", "conv2", "conv2_cls", "ctx2"])
def test_a_block_is_the_same_bits_in_any_batch(layer, card):
    x, w, b, pad = _operands(card, 128, layer, seed=1)
    full = C3.launch(x, w, b, 1, pad)
    assert torch.equal(full, C3.launch(x, w, b, 1, pad))
    for n in (1, 8):
        assert torch.equal(C3.launch(x[:n].contiguous(), w, b, 1, pad), full[:n])
    # block 77 alone, and at the front of a batch of 8
    assert torch.equal(C3.launch(x[77:78].contiguous(), w, b, 1, pad)[0], full[77])
    mixed = torch.cat([x[77:78], x[:7]]).contiguous()
    assert torch.equal(C3.launch(mixed, w, b, 1, pad)[0], full[77])


@pytest.mark.cuda
def test_graph_replay_is_the_eager_bits(card):
    x, w, b, pad = _operands(card, 16, "conv2", seed=2)
    eager = C3.launch(x, w, b, 1, pad)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        C3.launch(x, w, b, 1, pad)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = C3.LAUNCHES
    with torch.cuda.graph(graph, stream=stream):
        out = C3.launch(x, w, b, 1, pad)
    assert C3.LAUNCHES == before + 1  # counted at the capture
    x2 = _operands(card, 16, "conv2", seed=3)[0]
    x.copy_(x2)
    graph.replay()
    torch.cuda.synchronize()
    assert C3.LAUNCHES == before + 1  # a replay launches without the wrapper
    assert torch.equal(out, C3.launch(x2, w, b, 1, pad))
    x.copy_(_operands(card, 16, "conv2", seed=2)[0])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


@pytest.mark.cuda
def test_a_recon_batch_launches_three(card):
    """The f32 decode of one batch of 128 blocks at the flagship width runs
    conv1, conv2 and conv2_cls on the kernel (and the four transposed
    layers on the transposed conv kernel)."""
    from nvfpcc_tpu_torch.device import set_numerics
    from nvfpcc_tpu_torch.models import decoder as M

    set_numerics()
    dec = M.CompDecoder(M.build_model_spec(3, (8, 16, 8, 8))).to(card).eval()
    latent = torch.randn((128, 2, 2, 2, 3), generator=torch.Generator(device=card).manual_seed(4), device=card)
    before, before_t = C3.LAUNCHES, CT.LAUNCHES
    with torch.no_grad():
        occ = M.reconstruct(dec, latent)
    torch.cuda.synchronize()
    assert (C3.LAUNCHES - before, CT.LAUNCHES - before_t) == (3, 4)
    assert occ.shape == (128, 32, 32, 32, 1) and bool(torch.isfinite(occ).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_function_forward_by_dtype(dtype, card):
    """``Conv3d``'s forward: f32 is the kernel, bit for bit; bf16 stays
    cuDNN's, bit for bit."""
    cd = torch.float32 if dtype == "f32" else torch.bfloat16
    x, w, b, pad = _operands(card, 4, "conv2", seed=5, dtype=cd)
    bias = b if dtype == "f32" else None
    before = C3.LAUNCHES
    y = CT.Conv3d.apply(x, w, bias, 1, pad)
    assert C3.LAUNCHES == before + (dtype == "f32")
    want = C3.launch(x, w, bias, 1, pad) if dtype == "f32" else _cudnn(x, w, bias, pad)
    assert y.dtype == cd and torch.equal(y, want)


@pytest.mark.cuda
def test_refusals(card):
    x, w, b, pad = _operands(card, 2, "conv2_cls")
    with pytest.raises(ValueError, match="stride 1 only"):
        C3.launch(x, w, b, 2, pad)
    with pytest.raises(ValueError, match="stride 1 only"):  # no fallback through the Function
        CT.Conv3d.apply(x, w, b, 2, pad)
    with pytest.raises(TypeError, match="float32"):
        C3.launch(x.half(), w.half(), None, 1, pad)
    with pytest.raises(TypeError, match="float32"):
        C3.launch(x, w, b.double(), 1, pad)
    with pytest.raises(ValueError, match="contiguous"):
        C3.launch(x.transpose(1, 2), w, b, 1, pad)
    with pytest.raises(ValueError, match="CUDA tensors"):
        C3.launch(x, w.cpu(), b, 1, pad)
