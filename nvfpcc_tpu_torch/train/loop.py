"""Training loop: per-batch net updates + a once-per-epoch embedding update
(port of ``nvfpcc_tpu/train/loop.py``; channel and ctx-family entropy modes).

- The per-batch loop walks fixed-shape index batches; the variable last
  batch is a padded batch with a block mask, so the math is the JAX
  package's. Net parameters update per batch with Adam; the gathered
  embedding rows are constants there.
- The full-set embedding update runs the whole leaf set through the model
  with the parameters frozen and steps a second Adam on the embeddings only.
- Schedules: MultiStepLR([300,400,450], 0.1) written as a function of the
  number of updates already made (:func:`net_lr`, :func:`emb_lr`), which is
  how optax's ``piecewise_constant_schedule`` counts. The reference builds
  *both* schedulers over the net optimizer, so its net lr decays x0.01 per
  milestone and the embedding lr never decays; ``ref_sched_quirk``
  reproduces that.
- Random numbers come from a noise source handed to the epoch
  (:class:`NoiseSource`); nothing draws from a global RNG. The default
  source is re-seeded from ``(seed, epoch)`` at each epoch's start, so a
  resumed run draws what a straight run draws.

Master params, both Adam states, embeddings and all loss and rate math are
f32; ``cfg.compute_dtype="bf16"`` runs only the decoder convs in bf16.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.device import set_train_numerics
from nvfpcc_tpu_torch.models import decoder as M
from nvfpcc_tpu_torch.train import losses as L
from nvfpcc_tpu_torch.utils import checkpoint as ckpt_util
from nvfpcc_tpu_torch.utils.params import params_from_numpy, params_to_numpy

# the order of the per-step metric vector (rd_loss's dict, stacked on the
# device and fetched once per epoch)
METRIC_KEYS = (
    "loss", "bce", "ms0", "ms1", "pacc", "nacc", "bpp", "b_latent", "b_net",
    "sse", "denom", "lat_amax",
)


@dataclass
class TrainState:
    net: M.Net
    opt: torch.optim.Adam
    emb: torch.Tensor  # (N, 2, 2, 2, ch) f32 leaf, requires grad
    emb_opt: torch.optim.Adam
    epoch: int = 0


def _milestone_lr(base: float, count: int, boundaries, decay: float) -> float:
    """``base`` scaled by ``decay`` for every boundary with ``count >=
    boundary``; ``count`` is the number of updates already made."""
    return base * decay ** sum(count >= b for b in boundaries)


def _decays(cfg: TrainConfig):
    if cfg.ref_sched_quirk:
        return cfg.lr_decay**2, 1.0
    return cfg.lr_decay, cfg.lr_decay


def net_lr(cfg: TrainConfig, steps_per_epoch: int, count: int) -> float:
    """Net learning rate of the update made after ``count`` earlier ones."""
    bounds = [int(m) * steps_per_epoch for m in cfg.milestones]
    return _milestone_lr(cfg.lr, count, bounds, _decays(cfg)[0])


def emb_lr(cfg: TrainConfig, count: int) -> float:
    """Embedding learning rate (one update an epoch)."""
    return _milestone_lr(cfg.lr * cfg.wemb, count, [int(m) for m in cfg.milestones], _decays(cfg)[1])


def make_optimizers(cfg: TrainConfig, net: M.Net, emb: torch.Tensor):
    """(net_opt, emb_opt): two Adams with optax's defaults (b1 0.9, b2 0.999,
    eps 1e-8 added outside the square root). The epoch sets each one's lr
    from :func:`net_lr` / :func:`emb_lr` before every step."""
    net_opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
    emb_opt = torch.optim.Adam([emb], lr=cfg.lr * cfg.wemb, betas=(0.9, 0.999), eps=1e-8)
    return net_opt, emb_opt


def batch_plan(n_blocks: int, batch_size: int, shuffle: str, seed: int, epoch: int):
    """(idx (n_batches, B) int32, mask (n_batches, B) f32) covering all blocks.

    'stride' reproduces the reference pseudo-shuffle ``idx*2113 % N``
    (``utils/dataloader.py:165-167``). Padding rows are masked out.
    """
    if shuffle == "stride":
        perm = (np.arange(n_blocks, dtype=np.int64) * 2113) % n_blocks
    elif shuffle == "random":
        perm = np.random.default_rng(seed * 100003 + epoch).permutation(n_blocks)
    else:
        perm = np.arange(n_blocks)
    n_batches = -(-n_blocks // batch_size)
    pad = n_batches * batch_size - n_blocks
    idx = np.concatenate([perm, np.zeros(pad, np.int64)])
    mask = np.concatenate([np.ones(n_blocks, np.float32), np.zeros(pad, np.float32)])
    return (
        idx.reshape(n_batches, batch_size).astype(np.int32),
        mask.reshape(n_batches, batch_size),
    )


def rd_weights(cfg: TrainConfig):
    """(lambda, w1, w2) as the loss takes them."""
    return float(cfg.lmbda), float(cfg.w1), float(cfg.w2)


def rd_loss(
    net: M.Net,
    cfg: TrainConfig,
    emb_b: torch.Tensor,
    gt_b: torch.Tensor,
    dist_b: torch.Tensor,
    block_mask: Optional[torch.Tensor],
    n_total_pts: float,
    mode: str,
    q: int,
    noise: Optional[Dict[str, torch.Tensor]] = None,
    compute_dtype=None,
    n_pts_override=None,
):
    """The reference's full RD objective + metrics (``NVFPCC.py:160-196``).

    ``gt_b``/``dist_b`` are (B, 32, 32, 32, 1) channels-last f32.
    ``compute_dtype`` runs the decoder convs at lower precision; the loss
    and rate math here stay f32 either way. ``n_pts_override`` is the global
    point count a chunk of the full-set embedding update normalizes its
    latent rate by. Returns (loss, metrics dict of 0-dim tensors).
    """
    out, cls_list, net_bits, latent_bits_pb = M.net_apply(
        net, emb_b, mode, q, noise, compute_dtype=compute_dtype
    )
    lmbda, w1, w2 = rd_weights(cfg)

    if block_mask is not None:
        n_pts = (gt_b.reshape(gt_b.shape[0], -1).sum(1) * block_mask).sum()
        latent_bits = (latent_bits_pb * block_mask).sum()
    else:
        n_pts = gt_b.sum()
        latent_bits = latent_bits_pb.sum()
    if n_pts_override is not None:
        n_pts = n_pts_override

    b_latent = latent_bits / n_pts
    b_net = net_bits.sum() / n_total_pts
    bpp = b_latent + b_net
    bpp_loss = b_latent * w1 + b_net * w2

    ms = L.multiscale_gt(gt_b)
    ms_bce0 = L.focal_dense(cls_list[0], ms[0], alpha=cfg.ms_alpha, block_mask=block_mask)
    ms_bce1 = L.focal_dense(cls_list[1], ms[1], alpha=cfg.ms_alpha, block_mask=block_mask)
    bce = L.surf_focal_dense(
        out, gt_b, dist_b, beta=cfg.beta, alpha=cfg.focal_alpha, block_mask=block_mask
    )
    loss = bce + ms_bce0 + ms_bce1 + lmbda * bpp_loss

    with torch.no_grad():
        pacc, nacc = L.acc_dense(out, gt_b, block_mask=block_mask)
        sse, denom = L.sse1(out, gt_b, dist_b, cfg.sse_thh, block_mask=block_mask)
        # codable-alphabet guard: the coder clamps rounded latents outside
        # [-512, 512); track the max magnitude so drift toward the edge
        # shows during training, not first at encode time
        lat = torch.abs(torch.round(net.latent_gen(emb_b)))
        if block_mask is not None:
            lat = lat * block_mask.reshape((-1,) + (1,) * (lat.ndim - 1))
        lat_amax = lat.max()
    metrics = {
        "loss": loss, "bce": bce, "ms0": ms_bce0, "ms1": ms_bce1, "pacc": pacc, "nacc": nacc,
        "bpp": bpp, "b_latent": b_latent, "b_net": b_net, "sse": sse, "denom": denom,
        "lat_amax": lat_amax,
    }
    return loss, metrics


def _stack_metrics(metrics: dict) -> torch.Tensor:
    return torch.stack([metrics[k].detach().float() for k in METRIC_KEYS])


def _prep_dense(gt: np.ndarray, dist: np.ndarray, device):
    """Host grids (N,B,B,B) -> device channels-last f32 (N,B,B,B,1)."""
    gt_d = torch.as_tensor(np.asarray(gt), device=device).float()[..., None]
    dist_d = torch.as_tensor(np.asarray(dist), device=device).float()[..., None]
    return gt_d, dist_d


# auto chunking of the embedding update starts above this block count; it
# decides which clouds chunk (no vox10 cloud does), and chunking changes the
# noise draws, so it is the JAX package's value
EMB_CHUNK_BLOCKS = 4096


def resolve_emb_chunks(requested: int, n_blocks: int) -> int:
    """0 = auto: smallest chunk count keeping <= EMB_CHUNK_BLOCKS blocks per
    chunk; any positive value is taken as-is."""
    if requested and requested > 0:
        return int(requested)
    return max(1, -(-n_blocks // EMB_CHUNK_BLOCKS))


class NoiseSource:
    """The training noise, drawn on ``device`` from a generator of its own.

    ``start_epoch`` re-seeds it from ``(seed, epoch)``; ``draw`` then yields,
    call by call (one per net step, then one per chunk of the embedding
    update), the U(-0.5, 0.5) latent noise of the given shape under
    ``"latent"`` and, at q=1, one draw per transmitted kernel under its name
    (ctx1/ctx2 included in ctx modes). ctx modes form the rate on the rounded
    latents at q=2, so there a step draws nothing.
    """

    def __init__(self, seed: int, spec: M.ModelSpec, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.ctx = spec.entropy_mode in M.CTX_MODES
        names = M.TRANSMITTED_KERNELS + (M.CTX_KERNELS if self.ctx else ())
        self.kernel_shapes = {n: spec.specs[n].kernel_shape for n in names}

    def start_epoch(self, epoch: int, n_batches: int) -> None:
        self.gen.manual_seed((self.seed * 1_000_003 + int(epoch)) % (1 << 63))

    def draw(self, latent_shape, q: int) -> Dict[str, torch.Tensor]:
        if self.ctx and q != 1:
            return {}
        shapes = {"latent": tuple(latent_shape)}
        if q == 1:
            shapes.update(self.kernel_shapes)
        sizes = [int(np.prod(s)) for s in shapes.values()]
        # one draw for all of a step's noise, cut into views
        flat = torch.rand(sum(sizes), generator=self.gen, device=self.device) - 0.5
        return {n: t.reshape(s) for (n, s), t in zip(shapes.items(), flat.split(sizes))}


@contextlib.contextmanager
def _frozen(net: M.Net):
    """The parameters as constants: no weight gradient is computed inside."""
    params = [p for p in net.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def emb_full_grad(
    net, cfg, emb, gt, dist, block_valid, n_total_pts, q, noise: NoiseSource, emb_chunks=1
):
    """Gradient of the full-set embedding loss (reference ``NVFPCC.py:225-251``)
    with the parameters frozen, optionally in ``emb_chunks`` sequential block
    chunks. Every loss term is a sum over blocks, and the one global
    normalizer (the full-set point count dividing the latent rate) is passed
    into each chunk, so the chunk gradients concatenate to the full one. Each
    chunk draws its own noise. The block count must be a multiple of
    ``emb_chunks`` (``train`` pads)."""
    n = emb.shape[0]
    c = max(int(emb_chunks), 1)
    if n % c:
        raise ValueError(f"padded block count {n} not a multiple of emb_chunks {c}")
    n_pts_g = None
    if c > 1:
        n_pts_g = (gt.reshape(n, -1).sum(1) * block_valid).sum()
    grads = []
    with _frozen(net):
        for sl in (slice(i * (n // c), (i + 1) * (n // c)) for i in range(c)):
            emb_c = emb.detach()[sl].requires_grad_(True)
            loss, _ = rd_loss(
                net, cfg, emb_c, gt[sl], dist[sl], block_valid[sl], n_total_pts, "train", q,
                noise.draw(emb_c.shape, q), cfg.compute_dtype, n_pts_override=n_pts_g,
            )
            grads.append(torch.autograd.grad(loss, emb_c)[0])
    return grads[0] if c == 1 else torch.cat(grads)


def net_steps(
    state: TrainState, cfg: TrainConfig, gt, dist, idx, mask, n_total_pts: float, q: int,
    noise: NoiseSource, epoch: int,
) -> torch.Tensor:
    """The per-batch net updates of one epoch (Adam on the parameters; the
    gathered embedding rows are constants). Returns the per-step metrics
    stacked (n_batches, len(METRIC_KEYS)) on the device."""
    net, opt = state.net, state.opt
    params = list(net.parameters())
    n_batches = idx.shape[0]
    emb_const = state.emb.detach()
    rows = []
    for i in range(n_batches):
        bidx = idx[i]
        loss, metrics = rd_loss(
            net, cfg, emb_const[bidx], gt[bidx], dist[bidx], mask[i], n_total_pts, "train", q,
            noise.draw((bidx.shape[0],) + tuple(state.emb.shape[1:]), q), cfg.compute_dtype,
        )
        grads = torch.autograd.grad(loss, params)
        for p, g in zip(params, grads):
            p.grad = g
        lr = net_lr(cfg, n_batches, epoch * n_batches + i)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        rows.append(_stack_metrics(metrics))
    for p in params:
        p.grad = None
    return torch.stack(rows)


def emb_update(
    state: TrainState, cfg: TrainConfig, gt, dist, block_valid, n_total_pts: float, q: int,
    noise: NoiseSource, epoch: int, emb_chunks: int = 1,
) -> None:
    """The once-per-epoch full-set embedding update (the second Adam)."""
    state.emb.grad = emb_full_grad(
        state.net, cfg, state.emb, gt, dist, block_valid, n_total_pts, q, noise, emb_chunks
    )
    for group in state.emb_opt.param_groups:
        group["lr"] = emb_lr(cfg, epoch)
    state.emb_opt.step()
    state.emb.grad = None


def run_epoch(
    state: TrainState, cfg: TrainConfig, gt, dist, idx, mask, block_valid, n_total_pts: float,
    q: int, noise: NoiseSource, epoch: int, emb_chunks: int = 1,
) -> torch.Tensor:
    """One full epoch on ``state`` (in place): :func:`net_steps`, then
    :func:`emb_update`. ``idx``/``mask`` are :func:`batch_plan`'s on the
    device (``idx`` int64). Returns the per-step metrics on the device;
    nothing is fetched here."""
    noise.start_epoch(epoch, idx.shape[0])
    rows = net_steps(state, cfg, gt, dist, idx, mask, n_total_pts, q, noise, epoch)
    emb_update(state, cfg, gt, dist, block_valid, n_total_pts, q, noise, epoch, emb_chunks)
    state.epoch = epoch
    return rows


@torch.no_grad()
def evaluate(net, cfg, emb, gt, dist, block_valid, n_total_pts) -> dict:
    """Full-set eval at q=2 rounded latents, no noise, f32 (reference
    ``NVFPCC.py:308-364``). Returns the metrics as host floats."""
    _, metrics = rd_loss(
        net, cfg, emb.detach(), gt, dist, block_valid, n_total_pts, "eval", 2
    )
    return dict(zip(METRIC_KEYS, _stack_metrics(metrics).cpu().numpy()))


def summarize_metrics(metrics) -> dict:
    """Average stacked per-batch metrics the way the reference prints them
    (per-batch means; MSE1/PSNR1 from summed sse/denom, ``NVFPCC.py:256-281``)."""
    out = {}
    m = {k: np.asarray(v) for k, v in metrics.items()}
    cnt = max(m["loss"].size, 1)
    for k in ("loss", "bce", "ms0", "ms1", "pacc", "nacc", "bpp", "b_latent", "b_net"):
        out[k] = float(m[k].sum() / cnt) if m[k].ndim else float(m[k])
    sse, denom = float(m["sse"].sum()), float(m["denom"].sum())
    out["mse1"] = sse / max(denom, 1.0)
    out["psnr1"] = L.psnr1_from_sse(sse, max(denom, 1e-9))
    if "lat_amax" in m:
        out["lat_amax"] = float(m["lat_amax"].max())
    return out


class TrainDivergence(RuntimeError):
    """Raised when the loss goes non-finite."""


# warn when a rounded latent approaches the coder's +-512 alphabet edge: past
# it the codec clamps (parity-safe but rate-lossy), so drift should surface
# during training, not at encode time
LATENT_GUARD = 480.0


def initial_params(spec: M.ModelSpec, model_cfg: ModelConfig, device=None) -> M.Net:
    """Training start params: zero residuals (channel mode: sigma 1, mu 0).
    ``model_cfg.ctx_train_init="feature"`` starts the ctx predictor from
    :func:`models.decoder.ctx_feature_init` instead of zero residuals
    (measured worse for co-training by the JAX package, kept selectable)."""
    net = M.init_params(spec)
    if spec.entropy_mode in M.CTX_MODES and model_cfg.ctx_train_init == "feature":
        params_from_numpy(net.entropy, M.ctx_feature_init(spec))
    return net.to(device)


def checkpoint_meta(model_cfg: ModelConfig) -> dict:
    """The model metadata a per-epoch checkpoint carries (the JAX package's keys)."""
    return {
        "ch": model_cfg.ch,
        "chanstr": model_cfg.chanstr,
        "seed_tag": model_cfg.seed_tag,
        "entropy_mode": model_cfg.entropy_mode,
        "ctx_hidden": model_cfg.ctx_hidden,
        "ctx_tail": model_cfg.ctx_tail,
    }


def _pad_blocks(a: np.ndarray, n: int) -> np.ndarray:
    a = np.asarray(a)
    return np.concatenate([a, np.zeros((n - a.shape[0],) + a.shape[1:], a.dtype)])


def train(
    gt: np.ndarray,
    dist: np.ndarray,
    model_cfg: ModelConfig,
    cfg: TrainConfig,
    device,
    checkpoint_dir: Optional[str] = None,
    log: Callable[[str], None] = print,
    resume: bool = False,
    metrics_path: Optional[str] = None,
    profile_dir: Optional[str] = None,
    noise: Optional[NoiseSource] = None,
):
    """Full training run on ``device`` (reference ``train()``,
    ``NVFPCC.py:103-393``).

    ``gt`` (N,B,B,B) uint8, ``dist`` (N,B,B,B) f32. Returns (spec,
    TrainState); the state's embeddings hold the real blocks only. With
    ``resume`` the latest train-state snapshot in ``checkpoint_dir`` (params,
    both Adam states, embeddings, epoch) is restored. ``metrics_path``
    appends one JSON line of metrics per epoch. ``profile_dir`` receives a
    ``torch.profiler`` trace of epochs 3-5. ``noise`` replaces the default
    :class:`NoiseSource` (tests replay another package's draws through it).
    """
    device = torch.device(device)
    set_train_numerics()
    n_blocks = int(gt.shape[0])
    n_total_pts = float(gt.sum())
    spec = M.build_model_spec(
        model_cfg.ch, model_cfg.channels, model_cfg.seed_tag, model_cfg.entropy_mode,
        model_cfg.ctx_detach_pred, model_cfg.ctx_hidden, ctx_tail=model_cfg.ctx_tail,
    )

    emb_chunks = resolve_emb_chunks(cfg.emb_chunks, n_blocks)
    n_padded = n_blocks + (-n_blocks) % emb_chunks
    if n_padded != n_blocks:
        gt, dist = _pad_blocks(gt, n_padded), _pad_blocks(dist, n_padded)
    block_valid = torch.cat(
        [torch.ones(n_blocks), torch.zeros(n_padded - n_blocks)]
    ).to(device)

    net = initial_params(spec, model_cfg, device)
    emb = M.init_embeddings(n_padded, model_cfg.ch, device).requires_grad_(True)
    opt, emb_opt = make_optimizers(cfg, net, emb)
    state = TrainState(net, opt, emb, emb_opt)
    gt_d, dist_d = _prep_dense(gt, dist, device)
    if noise is None:
        noise = NoiseSource(cfg.seed, spec, device)

    start_epoch = 0
    if resume and checkpoint_dir is not None:
        snap_path = ckpt_util.latest_train_state(checkpoint_dir)
        if snap_path is not None:
            snap = ckpt_util.load_train_state(snap_path)
            if snap["emb"].shape[0] != n_padded:
                raise ValueError(
                    f"snapshot block axis {snap['emb'].shape[0]} != {n_padded} "
                    "(another cloud or chunking than the snapshot's?)"
                )
            ckpt_util.restore_train_state(state, snap)
            start_epoch = snap["epoch"] + 1
            log(f"[train] resumed from {snap_path} (epoch {snap['epoch']})")

    # profile a window after the warm-up epochs
    prof_start, prof_stop = 3, 5
    profiler = None

    def write_profile():
        profiler.stop()
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "train_trace.json"))
        log(f"[train] profiler trace written to {profile_dir}")

    for epoch in range(start_epoch, cfg.epochs):
        if profile_dir is not None and epoch == prof_start:
            profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
            )
            profiler.start()
        t0 = time.time()
        q = 1 if epoch < cfg.phase_change else 2
        idx, mask = batch_plan(n_blocks, cfg.batch_size, cfg.shuffle, cfg.seed, epoch)
        stacked = run_epoch(
            state, cfg, gt_d, dist_d, torch.as_tensor(idx, device=device).long(),
            torch.as_tensor(mask, device=device), block_valid, n_total_pts, q, noise, epoch,
            emb_chunks,
        )
        # the one fetch of the epoch; it also waits for the device
        stacked = stacked.cpu().numpy()
        epoch_s = time.time() - t0
        if profiler is not None and epoch >= prof_stop:
            write_profile()
            profiler = None
        s = summarize_metrics({k: stacked[:, j] for j, k in enumerate(METRIC_KEYS)})
        if not np.isfinite(s["loss"]):
            raise TrainDivergence(f"non-finite loss at epoch {epoch} (q={q}): {s}")
        if metrics_path is not None:
            with open(metrics_path, "a") as f:
                f.write(json.dumps({"epoch": epoch, "q": q, **s}) + "\n")
        log(
            f"[Epoch {epoch:04d} TRAIN {epoch_s:.1f}s] "
            f"Loss: {s['loss']:.4e} Pacc: {s['pacc']:.4f} Nacc: {s['nacc']:.4f} "
            f"S1: {s['ms0']:.1f} S2: {s['ms1']:.1f} bpp: {s['bpp']:.4f} "
            f"b_latent: {s['b_latent']:.4f} b_net: {s['b_net']:.4f} "
            f"MSE1: {s['mse1']:.4f} PSNR1: {s['psnr1']:.4f}"
        )

        if cfg.eval_every > 0 and epoch % cfg.eval_every == 0:
            es = summarize_metrics(
                evaluate(net, cfg, state.emb, gt_d, dist_d, block_valid, n_total_pts)
            )
            if es.get("lat_amax", 0.0) > LATENT_GUARD:
                warnings.warn(
                    f"epoch {epoch}: max |rounded latent| = {es['lat_amax']:.0f} "
                    f"is approaching the coder alphabet edge (512); encode "
                    "will clamp (rate loss). Consider a larger lambda*w1 or "
                    "checking for divergence."
                )
            log(
                f"[Epoch {epoch:04d} TEST] Loss: {es['loss']:.4e} "
                f"Pacc: {es['pacc']:.4f} Nacc: {es['nacc']:.4f} bpp: {es['bpp']:.4f} "
                f"b_latent: {es['b_latent']:.4f} b_net: {es['b_net']:.4f} "
                f"MSE1: {es['mse1']:.4f} PSNR1: {es['psnr1']:.4f}"
            )
            if checkpoint_dir is not None:
                ckpt_util.save_checkpoint(
                    checkpoint_dir, epoch, params_to_numpy(net),
                    state.emb.detach()[:n_blocks].cpu().numpy(), meta=checkpoint_meta(model_cfg),
                )
                ckpt_util.save_train_state(checkpoint_dir, epoch, state)

    if profiler is not None:  # the run ended inside the window
        write_profile()
    # strip the chunk padding from the returned embeddings
    if n_padded != n_blocks:
        state = TrainState(net, opt, state.emb.detach()[:n_blocks], emb_opt, state.epoch)
    return spec, state
