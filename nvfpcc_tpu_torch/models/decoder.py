"""The NVF codec model, channel entropy mode (port of
``nvfpcc_tpu/models/decoder.py``): latent generator + per-channel Gaussian
bottleneck + CompDecoder, as ``nn.Module``s whose parameter names are the
JAX params tree's paths (``decoder.up0.kernel`` <-> ``decoder/up0/kernel``).

Decoder shape chain on a 2^3 latent: ``up0`` (deconv k5 s2 p2 op1) 2->4 +
IGDN, ``conv0`` (deconv k5 s2 p2 op1) 4->8 + ReLU [aux head conv0_cls],
``up1`` (deconv k5 s2) 8->19 + ReLU, ``conv1`` (k4 valid) 19->16 + ReLU
[aux head conv1_cls], ``up2`` (deconv k5 s2) 16->35 + ReLU, ``conv2`` (k4
valid) 35->32 + ReLU, ``conv2_cls`` (k3 p1) + sigmoid -> occupancy.

Seven kernels are transmitted (quantized residuals): up0, conv0, up1, conv1,
up2, conv2, conv2_cls. The aux heads and the latent generator are
training-only. Noise for the q=1 phase and for the train-mode bottleneck is
an argument; nothing here draws random numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nvfpcc_tpu_torch.utils import seeds
from nvfpcc_tpu_torch.ops import rate
from nvfpcc_tpu_torch.ops.conv import IConv3d, QConv3d, QConvTranspose3d, make_qspec
from nvfpcc_tpu_torch.ops.gdn import GDN
from nvfpcc_tpu_torch.ops.ste import bypass_round, bypass_round16

# stable per-layer seed indices (decoder-regenerable; order is part of the
# format — the same table as the JAX package's, channel-mode layers only)
_LAYER_SEED_IDX = {
    "latent_gen": 0,
    "up0": 1,
    "conv0": 2,
    "up1": 3,
    "conv1": 4,
    "up2": 5,
    "conv2": 6,
    "conv2_cls": 7,
    "conv1_cls": 8,
    "conv0_cls": 9,
}

TRANSMITTED_KERNELS = ("up0", "conv0", "up1", "conv1", "up2", "conv2", "conv2_cls")

# entropy modes of the JAX package that this port does not run yet, and the
# ROADMAP item that ports each
_NOT_PORTED_MODES = {
    "spatio": "A12", "gmm": "A12", "factorized": "A12", "ctx": "A13", "ctx_ar": "A13",
}


@dataclass(frozen=True)
class ModelSpec:
    """Static model description: channel plan + per-layer specs with seeded inits."""

    ch: int
    channels: Tuple[int, int, int, int]
    specs: dict  # name -> QSpec
    seed_tag: str
    entropy_mode: str = "channel"

    @property
    def latent_shape(self) -> Tuple[int, int, int, int]:
        return (2, 2, 2, self.ch)


def build_model_spec(
    ch: int = 3,
    channels: Tuple[int, int, int, int] = (8, 16, 8, 8),
    seed_tag: str = seeds.DEFAULT_TAG,
    entropy_mode: str = "channel",
) -> ModelSpec:
    """Layer specs of the reference architecture (channel mode only)."""
    if entropy_mode in _NOT_PORTED_MODES:
        raise NotImplementedError(
            f"entropy_mode {entropy_mode!r} is not ported to nvfpcc_tpu_torch yet "
            f"(ROADMAP {_NOT_PORTED_MODES[entropy_mode]}); only 'channel' runs here"
        )
    if entropy_mode != "channel":
        raise ValueError(f"unknown entropy_mode: {entropy_mode}")
    key = seeds.base_key(seed_tag)
    c0, c1, c2, c3 = channels

    def k(name):
        return seeds.layer_key(key, _LAYER_SEED_IDX[name])

    specs = {
        "latent_gen": make_qspec(k("latent_gen"), "conv", ch, ch, 1, 1, 0),
        "up0": make_qspec(k("up0"), "conv_transpose", ch, c0, 5, 2, 2, output_padding=1),
        "conv0": make_qspec(k("conv0"), "conv_transpose", c0, c1, 5, 2, 2, output_padding=1),
        "up1": make_qspec(k("up1"), "conv_transpose", c1, c2, 5, 2, 0),
        "conv1": make_qspec(k("conv1"), "conv", c2, c2, 4, 1, 0),
        "up2": make_qspec(k("up2"), "conv_transpose", c2, c3, 5, 2, 0),
        "conv2": make_qspec(k("conv2"), "conv", c3, c3, 4, 1, 0),
        "conv2_cls": make_qspec(k("conv2_cls"), "conv", c3, 1, 3, 1, 1),
        "conv1_cls": make_qspec(k("conv1_cls"), "conv", c2, 1, 3, 1, 1),
        "conv0_cls": make_qspec(k("conv0_cls"), "conv", c1, 1, 3, 1, 1),
    }
    return ModelSpec(ch=ch, channels=tuple(channels), specs=specs, seed_tag=seed_tag)


class GaussianParams(nn.Module):
    """A learned ``(sigma, mu)`` pair: per latent channel for the entropy
    bottleneck, scalar for the weight-rate model."""

    def __init__(self, n: int):
        super().__init__()
        self.sigma = nn.Parameter(torch.ones((n,), dtype=torch.float32))
        self.mu = nn.Parameter(torch.zeros((n,), dtype=torch.float32))


class LatentGen(nn.Module):
    """1x1x1 seeded conv + GDN over per-block embeddings (N, 2, 2, 2, ch)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.conv = IConv3d(spec.specs["latent_gen"])
        self.gdn = GDN(spec.ch)

    def forward(self, emb: torch.Tensor) -> torch.Tensor:
        return self.gdn(self.conv(emb))


class CompDecoder(nn.Module):
    """The seeded quantized deconv chain (reference ``CompDecoder``)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.ch = spec.ch
        s = spec.specs
        self.up0 = QConvTranspose3d(s["up0"])
        self.conv0 = QConvTranspose3d(s["conv0"])
        self.up1 = QConvTranspose3d(s["up1"])
        self.conv1 = QConv3d(s["conv1"])
        self.up2 = QConvTranspose3d(s["up2"])
        self.conv2 = QConv3d(s["conv2"])
        self.conv2_cls = QConv3d(s["conv2_cls"])
        self.conv1_cls = IConv3d(s["conv1_cls"])
        self.conv0_cls = IConv3d(s["conv0_cls"])
        self.igdn = GDN(spec.channels[0], inverse=True)
        self.wrate = GaussianParams(1)

    def forward(
        self,
        latent: torch.Tensor,
        q: int = 2,
        noise: Optional[Dict[str, torch.Tensor]] = None,
        aux: bool = True,
    ):
        """Returns ``(occupancy (B,32,32,32,1), [cls0, cls1, occupancy],
        net_bits (7,))``. ``noise`` maps each transmitted kernel's name to
        its U(-0.5, 0.5) draw (q=1 only). ``aux=False`` is the decode-only
        path: the aux heads and the weight-rate model are skipped."""
        if latent.ndim != 5 or tuple(latent.shape[1:]) != (2, 2, 2, self.ch):
            raise ValueError(f"latent must be (B, 2, 2, 2, {self.ch}), got {tuple(latent.shape)}")
        nz = noise or {}
        relu = torch.relu
        out = self.igdn(self.up0(latent, q, nz.get("up0")))
        out = relu(self.conv0(out, q, nz.get("conv0")))
        cls0 = torch.sigmoid(self.conv0_cls(out)) if aux else None
        out = relu(self.up1(out, q, nz.get("up1")))
        out = relu(self.conv1(out, q, nz.get("conv1")))
        cls1 = torch.sigmoid(self.conv1_cls(out)) if aux else None
        out = relu(self.up2(out, q, nz.get("up2")))
        out = relu(self.conv2(out, q, nz.get("conv2")))
        out = torch.sigmoid(self.conv2_cls(out, q, nz.get("conv2_cls")))
        if not aux:
            return out, [None, None, out], out.new_zeros((len(TRANSMITTED_KERNELS),))
        wrate = {"sigma": self.wrate.sigma, "mu": self.wrate.mu}
        net_bits = torch.stack([
            rate.scalar_gaussian_rate(wrate, bypass_round16(getattr(self, n).kernel))
            for n in TRANSMITTED_KERNELS
        ])
        return out, [cls0, cls1, out], net_bits


class Net(nn.Module):
    """Latent generator + entropy bottleneck + decoder: the whole params tree."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.latent_gen = LatentGen(spec)
        self.entropy = GaussianParams(spec.ch)
        self.decoder = CompDecoder(spec)


def init_params(spec: ModelSpec, device=None) -> Net:
    """Zero residuals, entropy sigma 1 / mu 0, seeded inits as buffers."""
    return Net(spec).to(device)


def init_embeddings(n_blocks: int, ch: int, device=None) -> torch.Tensor:
    """Per-block latent embeddings (N, 2, 2, 2, ch), init ones."""
    return torch.ones((n_blocks, 2, 2, 2, ch), dtype=torch.float32, device=device)


def entropy_apply(net: Net, x: torch.Tensor, mode: str, noise: Optional[torch.Tensor] = None):
    """Latent bottleneck: STE round + Gaussian rate. ``mode="train"`` forms
    the rate on ``x + noise`` (``noise`` ~ U(-0.5, 0.5), passed in).
    Returns ``(x_rounded, bits)`` with ``bits`` shaped like ``x``."""
    x_rounded = bypass_round(x)
    if mode == "train":
        if noise is None:
            raise ValueError("train-mode entropy bottleneck needs its noise U(-0.5, 0.5)")
        x_form = x + noise
    else:
        x_form = x_rounded
    bits = rate.gaussian_bits(x_form, torch.abs(net.entropy.sigma), net.entropy.mu, step=1.0)
    return x_rounded, bits


def reconstruct(decoder: CompDecoder, latent: torch.Tensor) -> torch.Tensor:
    """Decode-only forward at q=2 (works on the decode-minimal params)."""
    out, _, _ = decoder(latent, q=2, aux=False)
    return out


def get_latent_code(net: Net, emb: torch.Tensor) -> dict:
    """Quantized latents + the channel (sigma, mu) for the range coder."""
    rounded, bits = entropy_apply(net, net.latent_gen(emb), mode="eval")
    return {
        "quantized_latent": rounded,
        "latent_bits": bits.sum(),
        "sigma": torch.abs(net.entropy.sigma),
        "mu": net.entropy.mu,
    }


def get_network_bits(net: Net) -> float:
    """Signaled network size estimate in bits: kernel-residual rate plus the
    reference's fixed fp32 accounting of the as-is aux params and the
    per-channel (sigma, mu)."""
    dec = net.decoder
    wrate = {"sigma": dec.wrate.sigma, "mu": dec.wrate.mu}
    net_bits = sum(
        float(rate.scalar_gaussian_rate(wrate, bypass_round16(getattr(dec, n).kernel)))
        for n in TRANSMITTED_KERNELS
    )
    c = net.spec.channels
    aux_bits = sum(c[i] * 2 for i in (1, 2, 3)) * 32 + 32 + (c[1] ** 2 + c[1]) * 32
    entropy_bits = net.spec.ch * 2 * 32
    return net_bits + aux_bits + entropy_bits


def count_transmitted_residuals(spec: ModelSpec) -> int:
    """Number of coded residual weights (~51.4k at the reference config)."""
    return int(sum(np.prod(spec.specs[n].kernel_shape) for n in TRANSMITTED_KERNELS))
