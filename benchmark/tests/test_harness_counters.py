"""The operation and byte counters against hand counts and against the
library's own convolution at tiny shapes."""

import pytest
import torch
import torch.nn.functional as F

from benchmark import counters as C

FLAGSHIP = {"ch": 3, "chanstr": "8,16,8,8", "entropy_mode": "channel", "train": {"compute_dtype": "bf16"}}
TINY = {"ch": 1, "chanstr": "1,1,1,1", "entropy_mode": "channel", "train": {"compute_dtype": "bf16"}}


def test_taps_by_hand():
    # k3 p1 over 4 voxels: 4 outputs x 3 taps, less the 2 that fall off the ends
    assert C.taps_1d("conv", 4, 3, 1, 1, 0) == (4, 10)
    # k4 valid over 19 voxels: 16 outputs, every tap inside
    assert C.taps_1d("conv", 19, 4, 1, 0, 0) == (16, 64)
    # deconv k5 s2 p2 op1 over 2: 4 outputs; input 0 lands taps 2..4, input 1 taps 0..3
    assert C.taps_1d("deconv", 2, 5, 2, 2, 1) == (4, 7)
    # deconv k5 s2 p0 over 8: 19 outputs, no tap cropped
    assert C.taps_1d("deconv", 8, 5, 2, 0, 0) == (19, 40)


@pytest.mark.parametrize("kind,n,k,s,p,op", [
    ("conv", 5, 3, 1, 1, 0), ("conv", 7, 4, 1, 0, 0), ("deconv", 2, 5, 2, 2, 1), ("deconv", 3, 5, 2, 0, 0),
])
def test_taps_match_the_library(kind, n, k, s, p, op):
    """All-ones input and kernel: the output sums the taps that meet an input voxel."""
    x = torch.ones(1, 2, n, n, n, dtype=torch.float64)
    if kind == "conv":
        y = F.conv3d(x, torch.ones(3, 2, k, k, k, dtype=torch.float64), stride=s, padding=p)
    else:
        y = F.conv_transpose3d(x, torch.ones(2, 3, k, k, k, dtype=torch.float64), stride=s, padding=p,
                               output_padding=op)
    n_out, pairs = C.taps_1d(kind, n, k, s, p, op)
    assert y.shape[-1] == n_out
    assert float(y.sum()) == pairs**3 * 2 * 3


def test_flagship_chain_and_work():
    layers = {layer["name"]: layer for layer in C.chain(FLAGSHIP)}
    assert [layers[n]["n_out"] for n in ("up0", "conv0", "up1", "conv1", "up2", "conv2", "conv2_cls")] == \
        [4, 8, 19, 16, 35, 32, 32]
    assert layers["conv2"]["macs"] == 32**3 * 4**3 * 8 * 8
    assert layers["up2"]["macs"] == 80**3 * 8 * 8
    assert C.forward_flops(FLAGSHIP) == pytest.approx(400.37e6, rel=1e-4)
    assert len(C.chain(FLAGSHIP, aux=False)) == 7


def test_bytes_by_hand():
    # one channel everywhere: every layer's activations are its edges cubed
    edges = [(2, 4), (4, 8), (8, 8), (8, 19), (19, 16), (16, 16), (16, 35), (35, 32), (32, 32)]
    act = sum(a**3 + b**3 for a, b in edges)
    w = 125 * 4 + 64 * 2 + 27 * 3  # four k5 deconvs, two k4 convs, three k3 heads
    flops, bytes_ = C.train_epoch_work(TINY, n_blocks=10, n_calls_net=3, n_calls_emb=1)
    assert bytes_ == 2 * (act * 10 * 5 + w * (3 * 3 + 2 * 1))
    assert flops == 2.0 * sum(layer["macs"] for layer in C.chain(TINY)) * 10 * 5
    f, b = C.decode_work(TINY, n_blocks=4, n_calls=1)
    dec = [e for i, e in enumerate(edges) if i not in (2, 5)]
    assert b == 4 * (sum(a**3 + c**3 for a, c in dec) * 4 + (125 * 4 + 64 * 2 + 27))
    assert C.least_seconds(f, b, "f32") == max(f / 67e12, b / 3.35e12)
