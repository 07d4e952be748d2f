"""The NVF codec model (port of ``nvfpcc_tpu/models/decoder.py``): latent
generator + entropy bottleneck (per-channel Gaussian, or the masked-conv
context predictor of the ctx family) + CompDecoder, as ``nn.Module``s whose
parameter names are the JAX params tree's paths (``decoder.up0.kernel`` <->
``decoder/up0/kernel``, ``entropy.ctx1.kernel`` <-> ``entropy/ctx1/kernel``).

Decoder shape chain on a 2^3 latent: ``up0`` (deconv k5 s2 p2 op1) 2->4 +
IGDN, ``conv0`` (deconv k5 s2 p2 op1) 4->8 + ReLU [aux head conv0_cls],
``up1`` (deconv k5 s2) 8->19 + ReLU, ``conv1`` (k4 valid) 19->16 + ReLU
[aux head conv1_cls], ``up2`` (deconv k5 s2) 16->35 + ReLU, ``conv2`` (k4
valid) 35->32 + ReLU, ``conv2_cls`` (k3 p1) + sigmoid -> occupancy.

Seven kernels are transmitted (quantized residuals): up0, conv0, up1, conv1,
up2, conv2, conv2_cls; in ctx modes the two masked predictor kernels
(ctx1, ctx2) are transmitted too. The aux heads and the latent generator
are training-only. Noise for the q=1 phase and for the train-mode
bottleneck is an argument; nothing here draws random numbers.
:func:`net_apply` is the training forward.

Entropy modes: ``channel`` (one Gaussian ``(sigma, mu)`` per latent
channel), ``spatio`` (one per latent position and channel, shape (2, 2, 2,
ch)), ``gmm`` (a per-channel 2-component Gaussian mixture), ``factorized``
(a per-channel monotone logit-CDF MLP), and the ctx family. ``ctx``
predicts each latent position's (mu, sigma) from the causally earlier
positions of its block with two masked 3^3 convs; ``ctx_ar`` also lets
channel c see the same position's channels < c, and may split off
``ctx_tail`` payload-cheap tail units that ctx2 reads only through the
gated center tap. The entropy model is coding-path numerics and stays f32
whatever the compute dtype.

A decoder cast to bfloat16 (``CompDecoder.to(torch.bfloat16)``: the
residuals, the seeded inits and the IGDN params) runs the whole decode
chain in bf16 — effective kernel, STE, convs with the bias added after
the rounded conv result, IGDN and sigmoid — which is the JAX package's
``recon_dtype="bf16"`` program; :func:`reconstruct` upcasts its output to
f32 exactly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from nvfpcc_tpu_torch.utils import seeds
from nvfpcc_tpu_torch.ops import rate
from nvfpcc_tpu_torch.ops.conv import (
    IConv3d, QConv3d, QConvTranspose3d, as_compute_dtype, channel_ar_mask, make_masked_qspec,
    make_qspec,
)
from nvfpcc_tpu_torch.ops.gdn import GDN
from nvfpcc_tpu_torch.ops.ste import bypass_round, bypass_round16

# stable per-layer seed indices (decoder-regenerable; order is part of the
# format — the same table as the JAX package's; ctx1/ctx2 were appended, so
# every older layer's seed stream is unchanged)
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
    "ctx1": 10,
    "ctx2": 11,
}

TRANSMITTED_KERNELS = ("up0", "conv0", "up1", "conv1", "up2", "conv2", "conv2_cls")

# the context model's (masked) kernels, whose residuals are transmitted too
CTX_KERNELS = ("ctx1", "ctx2")
CTX_MODES = ("ctx", "ctx_ar")  # spatial-only / + channel-autoregressive
CTX_HIDDEN = 8  # default predictor hidden width (the reference PredNet's)
CTX_SIGMA_FLOOR = 1e-6
# leaky-relu slope between the two masked convs: 1/16, so the host's
# integer-exact predictor (coder/ctx_coder.py) computes the same function
# in fixed point (floor division by 16)
CTX_LRELU_SLOPE = 1.0 / 16.0

ENTROPY_MODES = ("channel", "spatio", "gmm", "factorized") + CTX_MODES


@dataclass(frozen=True)
class ModelSpec:
    """Static model description: channel plan + per-layer specs with seeded inits."""

    ch: int
    channels: Tuple[int, int, int, int]
    specs: dict  # name -> QSpec
    seed_tag: str
    entropy_mode: str = "channel"
    ctx_hidden: int = CTX_HIDDEN  # masked-conv predictor hidden width
    ctx_tail: int = 0
    """ctx_ar only: the last ``ctx_tail`` of the ``ctx_hidden`` units are
    tail units, with full causal ctx1 taps but read by ctx2 only through the
    channel-gated center tap. Format-visible (the masks decide what is
    transmitted): pack ``model.ctx_tail``, checkpoint metadata, CLI."""
    ctx_detach_pred: bool = False
    """Training only: stop the rate gradient at the predictor's input, so
    the latents are shaped by distortion and their own rate only."""

    @property
    def latent_shape(self) -> Tuple[int, int, int, int]:
        return (2, 2, 2, self.ch)


def build_model_spec(
    ch: int = 3,
    channels: Tuple[int, int, int, int] = (8, 16, 8, 8),
    seed_tag: str = seeds.DEFAULT_TAG,
    entropy_mode: str = "channel",
    ctx_detach_pred: bool = False,
    ctx_hidden: int = CTX_HIDDEN,
    ctx_tail: int = 0,
) -> ModelSpec:
    """Layer specs of the reference architecture, plus the masked predictor
    (ctx1, ctx2) in ctx modes."""
    if entropy_mode not in ENTROPY_MODES:
        raise ValueError(f"unknown entropy_mode: {entropy_mode}")
    if ctx_tail and entropy_mode != "ctx_ar":
        raise ValueError(
            "ctx_tail needs entropy_mode=ctx_ar (plain ctx keeps the strict masks, "
            "whose ctx2 has no center tap — a center-only tail unit would be unreadable)"
        )
    if not 0 <= ctx_tail < max(ctx_hidden, 1):
        raise ValueError(f"ctx_tail must be in [0, ctx_hidden), got {ctx_tail}")
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
    if entropy_mode == "ctx":
        # two strictly causal masked convs over the 2^3 latent
        specs["ctx1"] = make_masked_qspec(k("ctx1"), ch, ctx_hidden, 3)
        specs["ctx2"] = make_masked_qspec(k("ctx2"), ctx_hidden, 2 * ch, 3)
    elif entropy_mode == "ctx_ar":
        # + channel autoregression: (mu_c, sigma_c) also see the same
        # position's channels < c; hidden unit i belongs to group i % ch
        m1 = channel_ar_mask(3, ch, ctx_hidden, in_group=lambda i: i,
                             out_group=lambda g: g % ch, center_strict=True)
        m2 = channel_ar_mask(3, ctx_hidden, 2 * ch, in_group=lambda g: g % ch,
                             out_group=lambda o: o % ch, center_strict=False)
        if ctx_tail:
            # tail units: only the (channel-gated) center ctx2 tap stays
            center = m2[1, 1, 1, ctx_hidden - ctx_tail:, :].copy()
            m2[:, :, :, ctx_hidden - ctx_tail:, :] = 0.0
            m2[1, 1, 1, ctx_hidden - ctx_tail:, :] = center
        specs["ctx1"] = make_masked_qspec(k("ctx1"), ch, ctx_hidden, 3, mask=m1)
        specs["ctx2"] = make_masked_qspec(k("ctx2"), ctx_hidden, 2 * ch, 3, mask=m2)
    return ModelSpec(
        ch=ch, channels=tuple(channels), specs=specs, seed_tag=seed_tag, entropy_mode=entropy_mode,
        ctx_hidden=ctx_hidden, ctx_tail=ctx_tail, ctx_detach_pred=ctx_detach_pred,
    )


def ctx_feature_init(spec: ModelSpec) -> dict:
    """The structured predictor init (numpy entropy subtree, JAX layout):
    layer 1 carries +-pass-through unit pairs of the axis-neighbour values
    x[p+d, c] (and, in ctx_ar, of the same position's earlier channels
    through the gated center), placed in hidden groups the layer-2 center
    gate can read; layer 2 starts at zero. Both layers' seeded inits are
    cancelled so the features are exact. From zero residuals the two masked
    layers' gradients are proportional to each other's weights and the fit
    stalls near the marginal rate; this init starts it from a quasi-linear
    predictor. The post-hoc fit's start, and training's with
    ``ctx_train_init=feature``."""
    ch = spec.ch
    s1, s2 = spec.specs["ctx1"], spec.specs["ctx2"]
    hidden = s1.out_ch
    k1 = -np.asarray(s1.kernel_init, np.float64).copy()
    mask1 = np.broadcast_to(np.asarray(s1.mask), s1.kernel_shape)
    groups = {g: [i for i in range(hidden) if i % ch == g] for g in range(ch)}
    spatial = [
        (dz, dy, dx, c) for (dz, dy, dx) in ((0, 0, -1), (0, -1, 0), (-1, 0, 0)) for c in range(ch)
    ]
    g0 = groups[0]
    pairs = [(g0[2 * j], g0[2 * j + 1]) for j in range(len(g0) // 2)]
    for (dz, dy, dx, c), (up, um) in zip(spatial, pairs):
        k1[dz + 1, dy + 1, dx + 1, c, up] += 1.0
        k1[dz + 1, dy + 1, dx + 1, c, um] -= 1.0
    if spec.entropy_mode == "ctx_ar":
        used: set = set()
        for cp in range(ch - 1):
            cands = [i for g in range(cp + 1, ch) for i in groups[g] if i not in used]
            if len(cands) >= 2:
                up, um = cands[0], cands[1]
                used.update((up, um))
                k1[1, 1, 1, cp, up] += 1.0
                k1[1, 1, 1, cp, um] -= 1.0
    k1 *= mask1  # no energy on masked taps (they are never coded)
    k2 = -np.asarray(s2.kernel_init, np.float64) * np.broadcast_to(np.asarray(s2.mask), s2.kernel_shape)
    return {
        "ctx1": {"kernel": k1.astype(np.float32), "b": np.zeros((s1.out_ch,), np.float32)},
        "ctx2": {"kernel": k2.astype(np.float32), "b": np.zeros((s2.out_ch,), np.float32)},
    }


class GaussianParams(nn.Module):
    """A learned ``(sigma, mu)`` pair of the given shape: per latent channel
    (channel mode) or per latent position and channel (spatio) for the
    entropy bottleneck, scalar for the weight-rate model."""

    def __init__(self, shape):
        super().__init__()
        self.sigma = nn.Parameter(torch.ones(shape, dtype=torch.float32))
        self.mu = nn.Parameter(torch.zeros(shape, dtype=torch.float32))


class EntropyLeaves(nn.Module):
    """The gmm or factorized entropy model: one parameter per leaf of its
    init dict (``ops.rate.gmm2_init`` / ``factorized_init``), under the JAX
    leaf names."""

    def __init__(self, init: dict):
        super().__init__()
        for name, value in init.items():
            self.register_parameter(name, nn.Parameter(value.clone()))

    def leaves(self) -> dict:
        return dict(self.named_parameters())


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
        self.wrate = GaussianParams((1,))

    def forward(
        self,
        latent: torch.Tensor,
        q: int = 2,
        noise: Optional[Dict[str, torch.Tensor]] = None,
        aux: bool = True,
        compute_dtype=None,
    ):
        """Returns ``(occupancy (B,32,32,32,1), [cls0, cls1, occupancy],
        net_bits (7,))``. ``noise`` maps each transmitted kernel's name to
        its U(-0.5, 0.5) draw (q=1 only). ``aux=False`` is the decode-only
        path: the aux heads and the weight-rate model are skipped.

        ``compute_dtype="bf16"`` (training only, never part of the pack
        format) runs the conv arithmetic in bf16 while master params, STE
        rounding and the rate math stay f32 (see ``ops.conv``). Activations
        stay bf16 between layers, except that IGDN returns f32; every
        pre-sigmoid logit is cast back to f32 so the focal-loss logs keep
        full precision."""
        if latent.ndim != 5 or tuple(latent.shape[1:]) != (2, 2, 2, self.ch):
            raise ValueError(f"latent must be (B, 2, 2, 2, {self.ch}), got {tuple(latent.shape)}")
        nz = noise or {}
        cd = as_compute_dtype(compute_dtype)
        relu = torch.relu
        f32 = (lambda t: t.float()) if cd is not None else (lambda t: t)
        out = self.igdn(self.up0(latent, q, nz.get("up0"), cd))
        out = relu(self.conv0(out, q, nz.get("conv0"), cd))
        cls0 = torch.sigmoid(f32(self.conv0_cls(out, cd))) if aux else None
        out = relu(self.up1(out, q, nz.get("up1"), cd))
        out = relu(self.conv1(out, q, nz.get("conv1"), cd))
        cls1 = torch.sigmoid(f32(self.conv1_cls(out, cd))) if aux else None
        out = relu(self.up2(out, q, nz.get("up2"), cd))
        out = relu(self.conv2(out, q, nz.get("conv2"), cd))
        out = torch.sigmoid(f32(self.conv2_cls(out, q, nz.get("conv2_cls"), cd)))
        if not aux:
            return out, [None, None, out], out.new_zeros((len(TRANSMITTED_KERNELS),))
        wrate = {"sigma": self.wrate.sigma, "mu": self.wrate.mu}
        net_bits = torch.stack([
            rate.scalar_gaussian_rate(wrate, bypass_round16(getattr(self, n).kernel))
            for n in TRANSMITTED_KERNELS
        ])
        return out, [cls0, cls1, out], net_bits


class CtxPredictor(nn.Module):
    """The context model's entropy subtree: two quantized masked convs with
    a leaky ReLU (slope 1/16) between them (reference ``PredNet``)."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.ch = spec.ch
        self.ctx1 = QConv3d(spec.specs["ctx1"])
        self.ctx2 = QConv3d(spec.specs["ctx2"])

    def forward(self, x_rounded: torch.Tensor, q: int = 2,
                noise: Optional[Dict[str, torch.Tensor]] = None):
        """Per-position ``(mu, sigma)`` of the latent ``x_rounded``
        (N, 2, 2, 2, ch), each position seeing only causally earlier ones.
        ``noise`` holds the q=1 kernel draws under ``"ctx1"``/``"ctx2"``.
        The input is always the rounded latent (teacher forcing); the host
        coder evaluates the same function incrementally."""
        nz = noise or {}
        h = self.ctx1(x_rounded, q, nz.get("ctx1"))
        # jax.nn.leaky_relu's form: its gradient at exactly 0 is 1 (that of
        # F.leaky_relu is the slope)
        h = torch.where(h >= 0, h, h * CTX_LRELU_SLOPE)
        out = self.ctx2(h, q, nz.get("ctx2"))
        return out[..., : self.ch], torch.abs(out[..., self.ch:]) + CTX_SIGMA_FLOOR


def _entropy_model(spec: ModelSpec) -> nn.Module:
    mode = spec.entropy_mode
    if mode in CTX_MODES:
        return CtxPredictor(spec)
    if mode == "gmm":
        return EntropyLeaves(rate.gmm2_init(spec.ch))
    if mode == "factorized":
        return EntropyLeaves(rate.factorized_init(spec.ch))
    return GaussianParams((spec.ch,) if mode == "channel" else spec.latent_shape)


class Net(nn.Module):
    """Latent generator + entropy bottleneck + decoder: the whole params tree."""

    def __init__(self, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.latent_gen = LatentGen(spec)
        self.entropy = _entropy_model(spec)
        self.decoder = CompDecoder(spec)


def init_params(spec: ModelSpec, device=None) -> Net:
    """Zero residuals (the ctx predictor's too, as the reference), entropy
    sigma 1 / mu 0 in channel and spatio modes, the deterministic gmm and
    factorized inits, seeded inits as buffers."""
    return Net(spec).to(device)


def init_embeddings(n_blocks: int, ch: int, device=None) -> torch.Tensor:
    """Per-block latent embeddings (N, 2, 2, 2, ch), init ones."""
    return torch.ones((n_blocks, 2, 2, 2, ch), dtype=torch.float32, device=device)


def entropy_apply(
    net: Net, x: torch.Tensor, mode: str, noise: Optional[torch.Tensor] = None, q: int = 2,
    pred_noise: Optional[Dict[str, torch.Tensor]] = None,
):
    """Latent bottleneck: STE round + the entropy mode's rate. Returns
    ``(x_rounded, bits)`` with ``bits`` shaped like ``x``.

    channel, spatio, gmm and factorized: ``mode="train"`` forms the rate on
    ``x + noise`` (``noise`` ~ U(-0.5, 0.5), passed in) at either q. ctx modes follow the kernel
    phase: at train q=1 the rate is formed on ``x + noise`` and the
    predictor's kernels take their q=1 noise (``pred_noise``); otherwise
    (q=2, or eval) it is formed on ``x_rounded`` and no noise is used."""
    x_rounded = bypass_round(x)
    if net.spec.entropy_mode in CTX_MODES:
        if mode == "train" and q == 1:
            if noise is None:
                raise ValueError("train-mode entropy bottleneck needs its noise U(-0.5, 0.5)")
            x_form = x + noise
        else:
            x_form = x_rounded
        pred_in = x_rounded.detach() if net.spec.ctx_detach_pred else x_rounded
        mu, sigma = net.entropy(pred_in, q, pred_noise)
        return x_rounded, rate.gaussian_bits(x_form, sigma, mu, step=1.0)
    if mode == "train":
        if noise is None:
            raise ValueError("train-mode entropy bottleneck needs its noise U(-0.5, 0.5)")
        x_form = x + noise
    else:
        x_form = x_rounded
    mode = net.spec.entropy_mode
    if mode == "gmm":
        bits = rate.gmm2_bits(x_form, net.entropy.leaves(), step=1.0)
    elif mode == "factorized":
        bits = rate.factorized_bits(x_form, net.entropy.leaves(), step=1.0)
    else:
        bits = rate.gaussian_bits(x_form, torch.abs(net.entropy.sigma), net.entropy.mu, step=1.0)
    return x_rounded, bits


def net_apply(
    net: Net,
    emb: torch.Tensor,
    mode: str,
    q: int,
    noise: Optional[Dict[str, torch.Tensor]] = None,
    compute_dtype=None,
):
    """Full forward (reference ``Net.forward``): returns ``(occupancy,
    cls_list, net_bits, latent_bits (B,))`` with the latent rate per block,
    so that padded batches can be masked. ``net_bits`` has one entry per
    transmitted kernel: 7, and 9 in ctx modes (the masked ctx kernels' rate
    joins the network rate).

    ``noise`` holds the U(-0.5, 0.5) draws: ``"latent"`` (shape of the
    latents, train mode; ctx modes only at q=1) and, at q=1, one per
    transmitted kernel under its name (ctx1/ctx2 included in ctx modes). The
    latent generator, the bottleneck and all rate math stay f32 whatever
    ``compute_dtype`` is (see :meth:`CompDecoder.forward`)."""
    nz = noise or {}
    latent = net.latent_gen(emb)
    latent_rounded, bits = entropy_apply(net, latent, mode, nz.get("latent"), q, nz)
    latent_bits = bits.reshape(bits.shape[0], -1).sum(dim=1)
    out, cls_list, net_bits = net.decoder(latent_rounded, q, nz, compute_dtype=compute_dtype)
    if net.spec.entropy_mode in CTX_MODES:
        net_bits = torch.cat([net_bits, ctx_kernel_bits(net)])
    return out, cls_list, net_bits, latent_bits


def ctx_kernel_bits(net: Net) -> torch.Tensor:
    """(2,) rate of the mask-visible (transmitted) ctx kernel entries under
    the weight-rate model. Masked taps never affect the output, so they are
    neither coded nor counted."""
    dec = net.decoder
    wrate = {"sigma": dec.wrate.sigma, "mu": dec.wrate.mu}
    return torch.stack([
        rate.scalar_gaussian_rate(wrate, bypass_round16(m.kernel.reshape(-1)[m.mask_idx]))
        for m in (net.entropy.ctx1, net.entropy.ctx2)
    ])


def reconstruct(decoder: CompDecoder, latent: torch.Tensor) -> torch.Tensor:
    """Decode-only forward at q=2 (works on the decode-minimal params) in
    the decoder's dtype, returned as f32: a bf16 decoder's occupancy is
    upcast exactly, before any caller compares it with a threshold (a bf16
    tensor compared with a Python float rounds the threshold to bf16)."""
    out, _, _ = decoder(latent.to(decoder.up0.kernel.dtype), q=2, aux=False)
    return out.float()


def get_latent_code(net: Net, emb: torch.Tensor) -> dict:
    """Quantized latents + the (sigma, mu) of channel and spatio modes for
    the range coder (the gmm and factorized params travel as they are). In
    ctx modes the host coder derives each symbol's table itself from the
    rounded latents and the transmitted ctx params, so only the latents
    export."""
    rounded, bits = entropy_apply(net, net.latent_gen(emb), mode="eval")
    out = {"quantized_latent": rounded, "latent_bits": bits.sum()}
    if net.spec.entropy_mode in ("channel", "spatio"):
        out["sigma"] = torch.abs(net.entropy.sigma)
        out["mu"] = net.entropy.mu
    return out


def get_network_bits(net: Net) -> float:
    """Signaled network size estimate in bits: kernel-residual rate plus the
    reference's fixed fp32 accounting of the as-is aux params and the
    entropy model: (sigma, mu) per channel or per position, every gmm or
    factorized leaf at 32 bits, and in ctx modes the masked ctx kernels'
    residual rate plus their fp32 biases."""
    dec = net.decoder
    wrate = {"sigma": dec.wrate.sigma, "mu": dec.wrate.mu}
    net_bits = sum(
        float(rate.scalar_gaussian_rate(wrate, bypass_round16(getattr(dec, n).kernel)))
        for n in TRANSMITTED_KERNELS
    )
    c = net.spec.channels
    aux_bits = sum(c[i] * 2 for i in (1, 2, 3)) * 32 + 32 + (c[1] ** 2 + c[1]) * 32
    if net.spec.entropy_mode in CTX_MODES:
        entropy_bits = float(ctx_kernel_bits(net).sum())
        entropy_bits += (net.spec.ctx_hidden + 2 * net.spec.ch) * 32
    elif net.spec.entropy_mode in ("gmm", "factorized"):
        entropy_bits = sum(p.numel() for p in net.entropy.parameters()) * 32
    else:
        entropy_bits = net.entropy.sigma.numel() * 2 * 32
    return net_bits + aux_bits + entropy_bits


def count_transmitted_residuals(spec: ModelSpec) -> int:
    """Number of coded residual weights (~51.4k at the reference config)."""
    return int(sum(np.prod(spec.specs[n].kernel_shape) for n in TRANSMITTED_KERNELS))
