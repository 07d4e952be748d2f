"""Plain PyTorch reference of the NVFPCC codec: what the benchmark holds the
program's timed path against.

It follows the published model (PCS 2022, huzi96/NVFPCC; the JAX package's
equations, which the port reproduces) with nothing of the program: its
own seed stream (``seeds.py``), its own layers, rate, losses and Adam,
written as plain tensor functions over a dict of leaves named by the
checkpoint format's paths (``decoder/up0/kernel``).

The model, on a (2, 2, 2, ch) latent per 32^3 block:

- latent generator: a seeded 1x1x1 conv and GDN over the block's embedding;
- bottleneck: round with a straight-through gradient; the rate under one
  Gaussian per latent channel (``channel``) at ``x + U(-0.5, 0.5)``, or in
  ``ctx`` mode under a (mu, sigma) that two causally masked 3^3 convs
  (leaky ReLU 1/16 between) predict from the rounded latent, at the
  rounded latent;
- decoder: up0 (deconv k5 s2 p2 op1) + IGDN, conv0 (deconv k5 s2 p2 op1) +
  ReLU [aux head conv0_cls], up1 (deconv k5 s2) + ReLU, conv1 (k4) + ReLU
  [aux head conv1_cls], up2 (deconv k5 s2) + ReLU, conv2 (k4) + ReLU,
  conv2_cls (k3 p1) + sigmoid. Every kernel is a seeded init plus a
  learned residual; the transmitted ones are rounded to the 1/16 grid at
  q=2 (straight-through);
- loss: the distance-weighted focal loss, the two aux focal losses, and
  lambda (w1 latent bpp + w2 weight bpp), the weight rate under one
  learned scalar Gaussian at step 1/16.

Precision: ``"f32"`` runs every conv in float32 (TF32 off, as the caller
sets it), ``"tf32"`` with its operands rounded to TF32 (the decode's
control); ``"bf16"`` is the configuration's training precision, emulated:
operands rounded to bfloat16, products summed in float32, each conv's
result rounded to bfloat16 and its bias added there, gradients rounded to
bfloat16 where they pass a cast; ``"fp8"`` is the control below it:
operands in float8 e4m3 and incoming gradients in e5m2, each with one
scale a tensor. Latent generator, bottleneck, rate and loss stay float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import seeds

REPARAM_OFFSET = 2.0 ** -18
PEDESTAL = REPARAM_OFFSET ** 2
BETA_BOUND = (1e-6 + PEDESTAL) ** 0.5
GAMMA_BOUND = REPARAM_OFFSET
LIKELIHOOD_FLOOR = 1e-8
CTX_SLOPE = 1.0 / 16.0
CTX_SIGMA_FLOOR = 1e-6
TRANSMITTED = ("up0", "conv0", "up1", "conv1", "up2", "conv2", "conv2_cls")
CTX_LAYERS = ("ctx1", "ctx2")


def layer_table(cfg: dict) -> Dict[str, tuple]:
    """name -> (kind, in, out, k, stride, pad, output_pad) of every seeded layer."""
    ch = cfg["ch"]
    c0, c1, c2, c3 = (int(c) for c in cfg["chanstr"].split(","))
    t = {
        "latent_gen": ("conv", ch, ch, 1, 1, 0, 0),
        "up0": ("deconv", ch, c0, 5, 2, 2, 1),
        "conv0": ("deconv", c0, c1, 5, 2, 2, 1),
        "up1": ("deconv", c1, c2, 5, 2, 0, 0),
        "conv1": ("conv", c2, c2, 4, 1, 0, 0),
        "up2": ("deconv", c2, c3, 5, 2, 0, 0),
        "conv2": ("conv", c3, c3, 4, 1, 0, 0),
        "conv2_cls": ("conv", c3, 1, 3, 1, 1, 0),
        "conv1_cls": ("conv", c2, 1, 3, 1, 1, 0),
        "conv0_cls": ("conv", c1, 1, 3, 1, 1, 0),
    }
    if cfg["entropy_mode"] == "ctx":
        h = cfg["ctx_hidden"]
        t["ctx1"] = ("conv", ch, h, 3, 1, 1, 0)
        t["ctx2"] = ("conv", h, 2 * ch, 3, 1, 1, 0)
    elif cfg["entropy_mode"] != "channel":
        raise ValueError(f"the reference models entropy modes channel and ctx, not {cfg['entropy_mode']}")
    return t


def causal_mask(k: int = 3) -> np.ndarray:
    """(k, k, k, 1, 1): 1 on the taps before the center in raster order."""
    m = np.zeros((k, k, k, 1, 1), np.float32)
    h = k // 2
    m[:h] = 1.0
    m[h, :h] = 1.0
    m[h, h, :h] = 1.0
    return m


def gdn_init(ch: int, device) -> dict:
    return {
        "beta": torch.sqrt(torch.ones(ch, device=device) + PEDESTAL),
        "gamma": torch.sqrt(0.1 * torch.eye(ch, device=device) + PEDESTAL),
    }


class Model:
    """The seeded inits and masks of one configuration on ``device``."""

    def __init__(self, cfg: dict, device):
        self.cfg, self.device = cfg, torch.device(device)
        self.table = layer_table(cfg)
        tag = cfg.get("seed_tag", seeds.DEFAULT_TAG)
        self.init = {}
        for name, (kind, cin, cout, k, *_rest) in self.table.items():
            kern, bias = seeds.layer_init(name, kind, cin, cout, k, tag)
            self.init[name] = (torch.from_numpy(kern).to(self.device), torch.from_numpy(bias).to(self.device))
        self.mask = {n: torch.from_numpy(causal_mask(3)).to(self.device) for n in CTX_LAYERS if n in self.table}
        self.ctx = cfg["entropy_mode"] == "ctx"

    def initial_params(self) -> Dict[str, torch.Tensor]:
        """The fit's start: zero residuals, GDN at its init, the channel
        Gaussians at sigma 1 / mu 0; float32 leaves that need a gradient."""
        p = {}
        for name, (_kind, cin, cout, k, *_rest) in self.table.items():
            base = ("latent_gen/conv" if name == "latent_gen" else
                    f"entropy/{name}" if name in CTX_LAYERS else f"decoder/{name}")
            p[f"{base}/kernel"] = torch.zeros((k, k, k, cin, cout), device=self.device)
            p[f"{base}/b"] = torch.zeros(cout, device=self.device)
        ch, c0 = self.cfg["ch"], int(self.cfg["chanstr"].split(",")[0])
        for base, n in (("latent_gen/gdn", ch), ("decoder/igdn", c0)):
            for key, v in gdn_init(n, self.device).items():
                p[f"{base}/{key}"] = v
        if not self.ctx:
            p["entropy/sigma"] = torch.ones(ch, device=self.device)
            p["entropy/mu"] = torch.zeros(ch, device=self.device)
        p["decoder/wrate/sigma"] = torch.ones(1, device=self.device)
        p["decoder/wrate/mu"] = torch.zeros(1, device=self.device)
        return {k: v.requires_grad_(True) for k, v in p.items()}


# -- straight-through rounding and gated bounds ------------------------------

class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        return torch.round(x * scale) / scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def ste_round(x, scale: float = 1.0):
    return _Round.apply(x, scale)


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it is
    negative (it would push x back up)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * ((x >= ctx.bound) | (g < 0)), None


def lower_bound(x, bound: float):
    return _LowerBound.apply(x, float(bound))


# -- float8 emulation (the control) -------------------------------------------

def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under one scale that maps its largest
    magnitude to the format's largest finite value."""
    amax = x.detach().abs().max().float()
    scale = torch.where(amax > 0, torch.finfo(dtype).max / amax, torch.ones_like(amax))
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Fp8Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


# -- layers ------------------------------------------------------------------

def _conv(kind, x, w, stride, pad, out_pad):
    """NDHWC activation, DHWIO kernel (I = a transposed conv's input)."""
    xn = x.permute(0, 4, 1, 2, 3)
    if kind == "conv":
        y = F.conv3d(xn, w.permute(4, 3, 0, 1, 2), None, stride, pad)
    else:
        y = F.conv_transpose3d(xn, w.permute(3, 4, 0, 1, 2), None, stride, pad, out_pad)
    return y.permute(0, 2, 3, 4, 1)


def conv_layer(spec, x, w, b, precision: str):
    """One seeded conv at ``precision`` (see the module docstring); returns
    float32 for ``f32``, else a bfloat16 activation."""
    kind, _cin, _cout, _k, stride, pad, out_pad = spec
    if precision == "f32":
        return _conv(kind, x.float(), w, stride, pad, out_pad) + b
    if precision == "tf32":
        return _conv(kind, tf32(x.float()), tf32(w), stride, pad, out_pad) + b
    xq = x.to(torch.bfloat16).float()
    wq = w.to(torch.bfloat16).float()
    if precision == "fp8":
        xq, wq = _Fp8Operand.apply(xq), _Fp8Operand.apply(wq)
        y = _Fp8Grad.apply(_conv(kind, xq, wq, stride, pad, out_pad))
    elif precision == "bf16":
        y = _conv(kind, xq, wq, stride, pad, out_pad)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return y.to(torch.bfloat16) + b.to(torch.bfloat16)


def norm_pool(p: dict, base: str, x):
    beta = lower_bound(p[f"{base}/beta"], BETA_BOUND) ** 2 - PEDESTAL
    gamma = lower_bound(p[f"{base}/gamma"], GAMMA_BOUND) ** 2 - PEDESTAL
    return torch.sqrt(torch.matmul((x * x).float(), gamma.t()) + beta)


def ndtr(x):
    """The standard normal CDF with erfc in the tails (float32)."""
    w = x * (0.5 * math.sqrt(2.0))
    z = w.abs()
    tail = torch.where(w > 0, 2.0 - torch.special.erfc(z), torch.special.erfc(z))
    return 0.5 * torch.where(z < 0.5 * math.sqrt(2.0), 1.0 + torch.special.erf(w), tail)


def gaussian_bits(x, sigma, mu, step: float = 1.0):
    half = 0.5 * step
    lik = ndtr((x - mu + half) / sigma) - ndtr((x - mu - half) / sigma)
    return -torch.log(lower_bound(lik, LIKELIHOOD_FLOOR)) / math.log(2.0)


class Forward:
    """The model's functions over a params dict ``p`` (leaves by path)."""

    def __init__(self, model: Model, precision: str = "f32"):
        self.m, self.precision = model, precision

    def kernel(self, p, name, q, noise=None):
        base = ("latent_gen/conv" if name == "latent_gen" else
                f"entropy/{name}" if name in CTX_LAYERS else f"decoder/{name}")
        r, rb = p[f"{base}/kernel"], p[f"{base}/b"]
        if q == 1:
            r = r + noise / 16.0
        elif q == 2:
            r = ste_round(r, 16.0)
        k = r + self.m.init[name][0]
        if name in self.m.mask:
            k = k * self.m.mask[name]
        return k, rb + self.m.init[name][1]

    def layer(self, p, name, x, q, noise=None, precision=None):
        w, b = self.kernel(p, name, q, noise)
        return conv_layer(self.m.table[name], x, w, b, precision or self.precision)

    def latent(self, p, emb):
        y = self.layer(p, "latent_gen", emb, 0, precision="f32")
        return y / norm_pool(p, "latent_gen/gdn", y)

    def ctx_predict(self, p, xr, q):
        h = self.layer(p, "ctx1", xr, q, precision="f32")
        h = torch.where(h >= 0, h, h * CTX_SLOPE)
        out = self.layer(p, "ctx2", h, q, precision="f32")
        ch = self.m.cfg["ch"]
        return out[..., :ch], out[..., ch:].abs() + CTX_SIGMA_FLOOR

    def bottleneck(self, p, latent, noise, q):
        """(rounded latent, bits per block)."""
        xr = ste_round(latent)
        if self.m.ctx:
            mu, sigma = self.ctx_predict(p, xr, q)
            bits = gaussian_bits(latent + noise if q == 1 else xr, sigma, mu)
        else:
            bits = gaussian_bits(latent + noise, p["entropy/sigma"].abs(), p["entropy/mu"])
        return xr, bits.reshape(bits.shape[0], -1).sum(1)

    def decoder(self, p, x, q=2, noise=None, aux=True):
        """(occupancy (B, 32, 32, 32, 1) float32, [cls0, cls1]) ."""
        nz = noise or {}
        relu = torch.relu
        y = self.layer(p, "up0", x, q, nz.get("up0"))
        y = y * norm_pool(p, "decoder/igdn", y)  # IGDN, float32
        y = relu(self.layer(p, "conv0", y, q, nz.get("conv0")))
        cls0 = torch.sigmoid(self.layer(p, "conv0_cls", y, 0).float()) if aux else None
        y = relu(self.layer(p, "up1", y, q, nz.get("up1")))
        y = relu(self.layer(p, "conv1", y, q, nz.get("conv1")))
        cls1 = torch.sigmoid(self.layer(p, "conv1_cls", y, 0).float()) if aux else None
        y = relu(self.layer(p, "up2", y, q, nz.get("up2")))
        y = relu(self.layer(p, "conv2", y, q, nz.get("conv2")))
        return torch.sigmoid(self.layer(p, "conv2_cls", y, q, nz.get("conv2_cls")).float()), [cls0, cls1]

    def weight_bits(self, p):
        """Bits of the transmitted kernel residuals under the scalar
        Gaussian (ctx layers: their mask-visible taps)."""
        sigma, mu = p["decoder/wrate/sigma"].abs(), p["decoder/wrate/mu"]
        out = [gaussian_bits(ste_round(p[f"decoder/{n}/kernel"], 16.0).reshape(-1), sigma, mu, 1 / 16).sum()
               for n in TRANSMITTED]
        for n in CTX_LAYERS if self.m.ctx else ():
            r = ste_round(p[f"entropy/{n}/kernel"], 16.0)
            vis = torch.broadcast_to(self.m.mask[n], r.shape).reshape(-1) > 0
            out.append(gaussian_bits(r.reshape(-1)[vis], sigma, mu, 1 / 16).sum())
        return torch.stack(out).sum()


def focal(pred, gt, alpha: float, block_mask, weight=None):
    occ = gt > 0
    prob = torch.clamp_min(torch.where(occ, pred, 1.0 - pred), 1e-9)
    a = torch.where(occ, alpha, 1.0 - alpha)
    t = -a * (1.0 - prob) ** 2 * torch.log(prob)
    if weight is not None:
        t = t * weight
    return (t * block_mask.reshape(-1, 1, 1, 1, 1)).sum()


def rd_loss(fw: Forward, p, emb, gt, dist, block_mask, n_total_pts: float, tcfg: dict, noise: dict, q: int = 2,
            n_pts: Optional[torch.Tensor] = None):
    """The RD objective of a batch (``gt``/``dist`` (B, 32, 32, 32, 1)
    float32, ``block_mask`` (B,)); ``n_pts`` overrides the batch's point
    count (the full-set update's chunks divide by the whole set's)."""
    lat = fw.latent(p, emb)
    xr, lat_bits = fw.bottleneck(p, lat, noise.get("latent"), q)
    out, (cls0, cls1) = fw.decoder(p, xr, q, noise)
    if n_pts is None:
        n_pts = (gt.reshape(gt.shape[0], -1).sum(1) * block_mask).sum()
    b_latent = (lat_bits * block_mask).sum() / n_pts
    b_net = fw.weight_bits(p) / n_total_pts
    g = gt.permute(0, 4, 1, 2, 3)
    ms1 = F.max_pool3d(g, 2, 2)
    ms0 = F.max_pool3d(ms1, 2, 2)
    ms0, ms1 = ms0.permute(0, 2, 3, 4, 1), ms1.permute(0, 2, 3, 4, 1)
    bce = focal(out, gt, tcfg["focal_alpha"], block_mask, weight=dist + (gt > 0) * tcfg["beta"])
    loss = (bce + focal(cls0, ms0, tcfg["ms_alpha"], block_mask) + focal(cls1, ms1, tcfg["ms_alpha"], block_mask)
            + tcfg["lmbda"] * (b_latent * tcfg["w1"] + b_net * tcfg["w2"]))
    return loss


def adam_update(g, m, v, t: float, lr: float):
    """(change, m, v) of one Adam step as optax defines it (b1 0.9, b2
    0.999, eps 1e-8 outside the square root) on a leaf with gradient ``g``
    and moments ``m``, ``v`` after ``t`` earlier steps."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    c1, c2 = 1.0 - 0.9 ** (t + 1), 1.0 - 0.999 ** (t + 1)
    return -lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8), m, v


class Adam:
    """:func:`adam_update` over a dict of leaves."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        for k, p in params.items():
            change, self.m[k], self.v[k] = adam_update(grads[k], self.m[k], self.v[k], self.t, self.lr)
            p.add_(change)
        self.t += 1


class NoiseStream:
    """The training noise as the configuration defines it: at each epoch a
    generator on the device seeded with ``(seed * 1000003 + epoch) mod
    2^63``; each draw is one ``torch.rand`` of the step's whole noise minus
    0.5, cut into the latent's (and at q=1 each transmitted kernel's)
    shape. At q=2 ctx mode draws nothing."""

    def __init__(self, seed: int, device):
        self.seed, self.device = int(seed), torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def start_epoch(self, epoch: int) -> None:
        self.gen.manual_seed((self.seed * 1_000_003 + int(epoch)) % (1 << 63))

    def draw(self, latent_shape, ctx: bool, q: int = 2) -> dict:
        if q != 2:
            raise ValueError("the reference follows the q=2 phase")
        if ctx:
            return {}
        n = int(np.prod(latent_shape))
        flat = torch.rand(n, generator=self.gen, device=self.device) - 0.5
        return {"latent": flat.reshape(latent_shape)}


def reconstruct(model: Model, p: dict, latents: torch.Tensor, block: int = 64, precision: str = "f32"):
    """Decode-only forward at q=2: occupancy (N, 32, 32, 32) float32 of
    integer latents (N, 2, 2, 2, ch), ``block`` blocks at a time, in float32
    (``"tf32"``: the control, operands rounded to TF32)."""
    fw = Forward(model, precision)
    outs = []
    with torch.no_grad():
        for i in range(0, latents.shape[0], block):
            occ, _ = fw.decoder(p, latents[i:i + block].to(model.device).float(), 2, aux=False)
            outs.append(occ[..., 0])
    return torch.cat(outs)
