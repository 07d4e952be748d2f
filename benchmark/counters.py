"""Operations and bytes of the codec's conv chain, from a configuration's
layer shapes, and the card's published peaks.

A layer's operations are its useful multiply-adds times two: for each
output voxel, the kernel taps that meet an input voxel (a padding tap or a
transposed conv's cropped contribution does no work), times input and
output channels. The three passes of training (forward, input gradient,
weight gradient) each do the same multiply-adds. A pass's bytes count its
input, its weights and its output once, in the dtype the pass runs in;
weights once per call.
"""

from __future__ import annotations

from benchmark.reference.nvfpcc import layer_table

# NVIDIA's data sheet, H100 SXM, dense
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bf16": 2, "f32": 4}

# the decoder's path on a 2^3 latent: (layer, its input edge)
DECODER_PATH = ("up0", "conv0", "conv0_cls", "up1", "conv1", "conv1_cls", "up2", "conv2", "conv2_cls")
AUX = ("conv0_cls", "conv1_cls")


def taps_1d(kind: str, n_in: int, k: int, stride: int, pad: int, out_pad: int):
    """(output edge, (output, tap) pairs that meet an input voxel) along one axis."""
    if kind == "conv":
        n_out = (n_in + 2 * pad - k) // stride + 1
        pairs = sum(1 for o in range(n_out) for t in range(k) if 0 <= o * stride - pad + t < n_in)
    else:
        n_out = (n_in - 1) * stride - 2 * pad + k + out_pad
        pairs = sum(1 for i in range(n_in) for t in range(k) if 0 <= i * stride - pad + t < n_out)
    return n_out, pairs


def chain(cfg: dict, aux: bool = True) -> list:
    """Per decoder layer: dict(name, n_in, n_out, macs per block, input,
    output and weight elements per block)."""
    table = layer_table(cfg)
    edge, out = 2, []
    for name in DECODER_PATH:
        kind, cin, cout, k, s, p, op = table[name]
        n_out, pairs = taps_1d(kind, edge, k, s, p, op)
        if name not in AUX or aux:
            out.append({
                "name": name, "n_in": edge, "n_out": n_out, "macs": pairs**3 * cin * cout,
                "in": edge**3 * cin, "out": n_out**3 * cout, "w": k**3 * cin * cout,
            })
        if name not in AUX:
            edge = n_out
    return out


def forward_flops(cfg: dict, aux: bool = True) -> float:
    """Operations of one block's decoder forward."""
    return 2.0 * sum(layer["macs"] for layer in chain(cfg, aux))


def train_epoch_work(cfg: dict, n_blocks: int, n_calls_net: int, n_calls_emb: int):
    """(operations, bytes) of the conv chain in one training epoch over
    ``n_blocks`` real blocks: the net steps run forward, input gradient and
    weight gradient; the embedding update forward and input gradient.
    ``n_calls_*`` count the calls, each of which reads the weights."""
    b = DTYPE_BYTES[cfg["train"]["compute_dtype"]]
    flops = bytes_ = 0.0
    for layer in chain(cfg, aux=True):
        # per block, each pass reads or writes one activation's worth on each
        # side: forward in + out, input gradient grad-out + grad-in, weight
        # gradient in + grad-out; 3 passes in the net steps, 2 in the update
        flops += 2.0 * layer["macs"] * n_blocks * 5
        bytes_ += b * (layer["in"] + layer["out"]) * n_blocks * 5
        bytes_ += b * layer["w"] * (3 * n_calls_net + 2 * n_calls_emb)
    return flops, bytes_


def decode_work(cfg: dict, n_blocks: int, n_calls: int):
    """(operations, bytes) of one f32 reconstruction of ``n_blocks`` blocks."""
    flops = bytes_ = 0.0
    for layer in chain(cfg, aux=False):
        flops += 2.0 * layer["macs"] * n_blocks
        bytes_ += 4.0 * ((layer["in"] + layer["out"]) * n_blocks + layer["w"] * n_calls)
    return flops, bytes_


def least_seconds(flops: float, bytes_: float, dtype: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS[dtype], bytes_ / PEAK_BYTES_PER_S)
