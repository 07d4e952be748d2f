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
- Block-DP (``train(mesh=...)``, ``nvfpcc_tpu_torch.parallel``): each rank
  holds a contiguous slice of the padded block axis (:class:`Shard`). A
  rank computes the loss terms of the rows of each global batch it holds,
  normalized by the whole batch's point count; the parameter-only weight
  rate counts on one rank; the decoder gradients are summed over the group
  in one flat all-reduce per net step (GDN's bound gates, which depend on
  the sign of the whole gradient, act after the sum), and every rank takes
  the same Adam step. Every rank draws what one process draws and keeps its rows, so
  block-DP follows one process's f32 trajectory.
- ``train`` runs chunks of epochs between host-visible boundaries
  (:func:`chunk_end`, the JAX package's cadence) and fetches a chunk's
  metric rows once. On a CUDA card, in one process, the gradients of the
  net step and of the embedding update are CUDA graphs
  (:class:`EpochProgram`, ``train/graphs.py``), replayed step by step, each
  followed by its Adam step: the counterpart of the JAX package's one
  compiled program per chunk (``make_epochs_fn``).

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
from nvfpcc_tpu_torch.ops.gdn import GDN
from nvfpcc_tpu_torch.parallel import mesh as pm
from nvfpcc_tpu_torch.train import losses as L
from nvfpcc_tpu_torch.train.graphs import capture
from nvfpcc_tpu_torch.utils import checkpoint as ckpt_util
from nvfpcc_tpu_torch.utils import trace
from nvfpcc_tpu_torch.utils.params import params_from_numpy, params_to_numpy

# the order of the per-step metric vector (rd_loss's dict, stacked on the
# device and fetched once per chunk of epochs)
METRIC_KEYS = (
    "loss", "bce", "ms0", "ms1", "pacc", "nacc", "bpp", "b_latent", "b_net",
    "sse", "denom", "lat_amax",
)
# under a mesh the rows also carry the accuracy counts: ratios from two
# ranks do not combine, counts do (pacc/nacc are recomputed after the sum)
ACC_COUNT_KEYS = ("tp", "ap", "tn", "an")
MESH_METRIC_KEYS = METRIC_KEYS + ACC_COUNT_KEYS


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
    from :func:`net_lr` / :func:`emb_lr` before every step. They step
    eagerly, also after a CUDA graph's replay (see :class:`EpochProgram`)."""
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
    count_net: bool = True,
    acc_counts: bool = False,
):
    """The reference's full RD objective + metrics (``NVFPCC.py:160-196``).

    ``gt_b``/``dist_b`` are (B, 32, 32, 32, 1) channels-last f32.
    ``compute_dtype`` runs the decoder convs at lower precision; the loss
    and rate math here stay f32 either way. ``n_pts_override`` is the global
    point count a chunk of the full-set embedding update, or a block-DP
    rank's share of a batch, normalizes its latent rate by. A rank that does
    not own the parameter-only weight rate passes ``count_net=False`` (its
    ``b_net`` is 0); ``acc_counts`` adds the accuracy counts
    (:data:`ACC_COUNT_KEYS`) to the metrics. Returns (loss, metrics dict of
    0-dim tensors).
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
    b_net = net_bits.sum() / n_total_pts if count_net else torch.zeros((), device=latent_bits.device)
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
        counts = L.acc_counts(out, gt_b, block_mask=block_mask)
        pacc, nacc = L.acc_ratios(*counts)
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
    if acc_counts:
        metrics.update(zip(ACC_COUNT_KEYS, counts))
    return loss, metrics


def _stack_metrics(metrics: dict, keys=METRIC_KEYS) -> torch.Tensor:
    return torch.stack([metrics[k].detach().float() for k in keys])


def _prep_dense(gt, dist, device):
    """Grids (N,B,B,B), host arrays or tensors -> device channels-last f32
    (N,B,B,B,1)."""
    gt_d = torch.as_tensor(gt, device=device).float()[..., None]
    dist_d = torch.as_tensor(dist, device=device).float()[..., None]
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


@dataclass
class Shard:
    """A rank's part of a block-DP run: its rows (:meth:`Mesh.rows`) of the
    padded block axis, the real block count, and the points of every padded
    block (host), from which each batch's global normalizer is summed."""

    mesh: pm.Mesh
    n_blocks: int
    block_pts: np.ndarray  # (n_padded,) int64; padding rows hold 0

    @property
    def rows(self) -> slice:
        return self.mesh.rows(len(self.block_pts))

    def batches(self, idx: torch.Tensor, mask: torch.Tensor) -> list:
        """Per global batch of :func:`batch_plan`, None when none of its
        blocks lies on this rank, else (local row indices, block mask,
        positions in the batch, the batch's point count as a 0-dim f32
        device tensor, whether this rank counts the weight rate: the one
        holding the batch's first block, which is never padding). Two
        host-to-device copies for the whole epoch."""
        lo, hi = self.rows.start, self.rows.stop
        idx_h, mask_h = idx.cpu().numpy(), mask.cpu().numpy()
        sels = [np.flatnonzero((b >= lo) & (b < hi)) for b in idx_h]
        flat = torch.as_tensor(np.concatenate(sels), device=idx.device)
        # a tensor, as one process computes it: CUDA divides by a host
        # scalar through its reciprocal, which rounds otherwise
        pts = torch.as_tensor((self.block_pts[idx_h] * mask_h).sum(1), dtype=torch.float32, device=idx.device)
        out, start = [], 0
        for i, sel in enumerate(sels):
            if not sel.size:
                out.append(None)
                continue
            sel_t = flat[start:start + sel.size]
            start += sel.size
            out.append((idx[i][sel_t] - lo, mask[i][sel_t], sel_t, pts[i], bool(lo <= idx_h[i, 0] < hi)))
        return out

    def emb_noise(self, noise, shape, q: int) -> Dict[str, torch.Tensor]:
        """One process's draw for the whole embedding update (at the real
        block count: the flat draw also holds the kernel noise, and the
        values a CUDA generator gives depend on the count), cut to this
        rank's rows; padding rows get zeros."""
        nz = noise.draw((self.n_blocks,) + tuple(shape[1:]), q)
        if "latent" in nz:
            r = self.rows
            part = nz["latent"][r.start:min(r.stop, self.n_blocks)]
            pad = r.stop - r.start - part.shape[0]
            if pad:
                part = torch.cat([part, part.new_zeros((pad,) + tuple(part.shape[1:]))])
            nz = {**nz, "latent": part}
        return nz


def _all_reduce_grads(mesh: pm.Mesh, grads) -> list:
    """The gradients summed over the group: one flat bucket, one all-reduce."""
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), timed=True)
    return [v.view_as(g) for g, v in zip(grads, flat.split([g.numel() for g in grads]))]


def _reduce_rows(mesh: pm.Mesh, rows: torch.Tensor) -> np.ndarray:
    """Per-rank metric rows (n, len(MESH_METRIC_KEYS)) -> the group's, on
    the host (one fetch): sums, the max for ``lat_amax``, and pacc/nacc
    from the summed counts (:func:`losses.acc_ratios`)."""
    keys = MESH_METRIC_KEYS
    j = keys.index("lat_amax")
    amax = mesh.all_reduce(rows[:, j].clone(), "max")  # a copy: one row's column is a view
    out = mesh.all_reduce(rows.contiguous())
    out[:, j] = amax
    pacc, nacc = L.acc_ratios(*(out[:, keys.index(k)] for k in ACC_COUNT_KEYS))
    out[:, keys.index("pacc")], out[:, keys.index("nacc")] = pacc, nacc
    return out.cpu().numpy()


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


@contextlib.contextmanager
def _gates_deferred(net: M.Net, on: bool):
    """With ``on``, GDN's bounds pass each rank's whole parameter gradient
    inside; the caller gates the group's sum (``GDN.gate_grads``), as one
    process gates the whole batch's. Yields the GDN modules."""
    gdns = [m for m in net.modules() if isinstance(m, GDN)] if on else []
    for m in gdns:
        m.defer_gate = True
    try:
        yield gdns
    finally:
        for m in gdns:
            m.defer_gate = False


def emb_full_grad(
    net, cfg, emb, gt, dist, block_valid, n_total_pts, q, noise: NoiseSource, emb_chunks=1,
    shard: Optional[Shard] = None,
):
    """Gradient of the full-set embedding loss (reference ``NVFPCC.py:225-251``)
    with the parameters frozen, optionally in ``emb_chunks`` sequential block
    chunks. Every loss term is a sum over blocks, and the one global
    normalizer (the full-set point count dividing the latent rate) is passed
    into each chunk, so the chunk gradients concatenate to the full one. Each
    chunk draws its own noise. The block count must be a multiple of
    ``emb_chunks`` (``train`` pads). With a ``shard`` the arrays are the
    rank's rows and the result is their gradient (one chunk; the rows are
    already a cut of the full set)."""
    n = emb.shape[0]
    c = max(int(emb_chunks), 1)
    if n % c or (shard is not None and c != 1):
        raise ValueError(f"padded block count {n} not a multiple of emb_chunks {c}, or chunks under a mesh")
    n_pts_g = None
    if c > 1:
        n_pts_g = (gt.reshape(n, -1).sum(1) * block_valid).sum()
    elif shard is not None:
        n_pts_g = torch.tensor(n_total_pts, dtype=torch.float32, device=emb.device)
    grads = []
    with _frozen(net):
        for sl in (slice(i * (n // c), (i + 1) * (n // c)) for i in range(c)):
            emb_c = emb.detach()[sl].requires_grad_(True)
            nz = noise.draw(emb_c.shape, q) if shard is None else shard.emb_noise(noise, emb_c.shape, q)
            loss, _ = rd_loss(
                net, cfg, emb_c, gt[sl], dist[sl], block_valid[sl], n_total_pts, "train", q,
                nz, cfg.compute_dtype, n_pts_override=n_pts_g,
            )
            grads.append(torch.autograd.grad(loss, emb_c)[0])
    return grads[0] if c == 1 else torch.cat(grads)


def _shard_net_steps(
    state: TrainState, cfg: TrainConfig, gt, dist, idx, mask, n_total_pts: float, q: int,
    noise: NoiseSource, epoch: int, shard: Shard,
) -> torch.Tensor:
    """A block-DP rank's per-batch net updates of one epoch (Adam on the
    parameters; the gathered embedding rows are constants). The arrays are
    the rank's rows, ``idx``/``mask`` the global plan on the device; the
    gradients are summed over the group before each step. Returns the
    rank's share of the metric rows, (n_batches, len(MESH_METRIC_KEYS)), on
    the device."""
    net, opt = state.net, state.opt
    params = list(net.parameters())
    n_batches = idx.shape[0]
    emb_const = state.emb.detach()
    noise_shape = (idx.shape[1],) + tuple(state.emb.shape[1:])
    rows = []
    with _gates_deferred(net, True) as gdns:
        for i, batch in enumerate(shard.batches(idx, mask)):
            nz = noise.draw(noise_shape, q)
            if batch is None:  # none of the batch's blocks is on this rank
                grads = [torch.zeros_like(p) for p in params]
                rows.append(torch.zeros(len(MESH_METRIC_KEYS), device=emb_const.device))
            else:
                bidx, bmask, sel, n_pts, owner = batch
                if "latent" in nz:
                    nz = {**nz, "latent": nz["latent"][sel]}
                loss, metrics = rd_loss(
                    net, cfg, emb_const[bidx], gt[bidx], dist[bidx], bmask, n_total_pts, "train", q,
                    nz, cfg.compute_dtype, n_pts_override=n_pts, count_net=owner, acc_counts=True,
                )
                # a rank that does not count the weight rate leaves its
                # parameters (the weight-rate model's) out of the graph
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
                rows.append(_stack_metrics(metrics, MESH_METRIC_KEYS))
            for p, g in zip(params, _all_reduce_grads(shard.mesh, grads)):
                p.grad = g
            for m in gdns:
                m.gate_grads()
            lr = net_lr(cfg, n_batches, epoch * n_batches + i)
            for group in opt.param_groups:
                group["lr"] = lr
            opt.step()
    for p in params:
        p.grad = None
    return torch.stack(rows)


class EpochProgram:
    """The epoch of one training run on its state, in place: the per-batch
    net steps, then the full-set embedding update (the counterpart of the
    JAX package's ``make_epoch_fn``; :func:`run_epoch` runs one epoch of it).

    In one process each step is split in two: the gradient (forward and
    backward, into fixed ``.grad`` tensors; the net step also writes its
    metric row into ``rows``), then the Adam step. The gradient reads
    everything that changes from one step to the next from buffers that
    keep their storage: the epoch's batch plan (``idx``/``mask``, copied in
    once an epoch), the step's row of it (a device counter ``i`` the net
    step advances) and the noise generator (re-seeded every epoch). With
    ``graphs`` the two gradients are CUDA graphs per q phase
    (``train/graphs.py``), captured at the phase's first epoch and replayed
    ``n_batches`` times, then once; without, they run eagerly, and the two
    give the same bits. Adam steps eagerly after each of them, with the lr
    of :func:`net_lr`/:func:`emb_lr` set as a float, as block-DP's ranks
    step: its bias corrections stay host doubles. A capturable Adam inside
    the graph would take them as f32 on the card; that moved the two-rank
    block-DP run, held against this one, past its bound on the card.

    With a ``shard`` (block-DP) the epoch is the rank's, always eager
    (:func:`_shard_net_steps`; a collective cannot be captured over gloo,
    and the rank's batches are cut on the host).

    While a profiler records, the epoch's stages are spans
    (``utils/trace.py``), all outside the captured steps."""

    def __init__(self, state: TrainState, cfg: TrainConfig, gt, dist, block_valid, n_total_pts: float,
                 noise: NoiseSource, emb_chunks: int = 1, shard: Optional[Shard] = None, graphs: bool = False):
        if graphs and (shard is not None or state.emb.device.type != "cuda"):
            raise ValueError("CUDA graphs of the epoch need a CUDA device and no mesh")
        self.state, self.cfg, self.gt, self.dist = state, cfg, gt, dist
        self.block_valid, self.n_total_pts, self.noise = block_valid, n_total_pts, noise
        self.emb_chunks, self.shard, self.use_graphs = emb_chunks, shard, graphs
        self.params = list(state.net.parameters())
        self.idx = None  # the fixed buffers, made at the first epoch (see _load_plan)
        self.graphs: Dict[int, tuple] = {}
        self.stream = torch.cuda.Stream(state.emb.device) if graphs else None

    def _load_plan(self, idx, mask) -> None:
        """Copy the epoch's plan into the buffers (made at the first call,
        with the ``.grad`` tensors); a host plan is copied without a wait."""
        if self.idx is None:
            dev = self.state.emb.device
            n, b = idx.shape
            self.idx = torch.zeros((n, b), dtype=torch.long, device=dev)
            self.mask = torch.zeros((n, b), dtype=torch.float32, device=dev)
            self.rows = torch.zeros((n, len(METRIC_KEYS)), dtype=torch.float32, device=dev)
            self.at = torch.arange(n, device=dev)[:, None]
            self.i = torch.zeros((1,), dtype=torch.long, device=dev)
            self.noise_shape = (b,) + tuple(self.state.emb.shape[1:])
            for p in self.params:
                p.grad = torch.zeros_like(p)
            self.state.emb.grad = torch.zeros_like(self.state.emb)
        elif tuple(idx.shape) != tuple(self.idx.shape):
            raise ValueError(f"batch plan {tuple(idx.shape)} != the program's {tuple(self.idx.shape)}")
        self.idx.copy_(idx, non_blocking=True)
        self.mask.copy_(mask, non_blocking=True)

    def _net_grad(self, q: int) -> None:
        """The gradient of net step ``i`` of the epoch (batch row ``i`` of
        the plan) into the ``.grad`` tensors; its metric row into
        ``rows[i]``; ``i`` on to the next row."""
        s = self.state
        bidx = self.idx.index_select(0, self.i)[0]
        bmask = self.mask.index_select(0, self.i)[0]
        nz = self.noise.draw(self.noise_shape, q)
        loss, metrics = rd_loss(
            s.net, self.cfg, s.emb.detach()[bidx], self.gt[bidx], self.dist[bidx], bmask, self.n_total_pts,
            "train", q, nz, self.cfg.compute_dtype,
        )
        grads = torch.autograd.grad(loss, self.params)
        with torch.no_grad():
            for p, g in zip(self.params, grads):
                p.grad.copy_(g)
            self.rows.copy_(torch.where(self.at == self.i, _stack_metrics(metrics), self.rows))
            # modulo the epoch's steps: every epoch starts at row 0, and a
            # capture's warm-up runs (restored after) may outnumber the steps
            self.i.add_(1).remainder_(self.idx.shape[0])

    def _emb_grad(self, q: int) -> None:
        s = self.state
        g = emb_full_grad(s.net, self.cfg, s.emb, self.gt, self.dist, self.block_valid, self.n_total_pts, q,
                          self.noise, self.emb_chunks)
        with torch.no_grad():
            s.emb.grad.copy_(g)

    def _graphs_for(self, q: int) -> tuple:
        """(net gradient, embedding gradient) graphs of phase ``q``,
        captured at its first use; a phase's graphs are dropped when the
        next begins (the run never returns to it). The two share one memory
        pool: they never run at the same time. Of the training state they
        change only ``rows`` and ``i`` (the ``.grad`` tensors are outputs)."""
        if q not in self.graphs:
            self.graphs.clear()
            mutated, gens = [self.rows, self.i], [self.noise.gen]
            with trace.span("train.graph_capture"):
                net = capture(lambda: self._net_grad(q), mutated, gens, stream=self.stream)
            with trace.span("train.graph_capture"):
                emb = capture(lambda: self._emb_grad(q), mutated, gens, pool=net.pool(), stream=self.stream)
            self.graphs[q] = (net, emb)
        return self.graphs[q]

    def net_steps(self, epoch: int, q: int, idx, mask) -> None:
        """The epoch's per-batch net steps over the plan ``idx``/``mask``
        (:func:`batch_plan`'s, host or device); the rows land in ``rows``."""
        with trace.span("train.net_steps", device=True):
            with trace.span("train.load_plan"):
                self._load_plan(idx, mask)
            graph = self._graphs_for(q)[0] if self.use_graphs else None
            n, opt = self.idx.shape[0], self.state.opt
            for i in range(n):
                with trace.span("train.net_grad", device=True):
                    if graph is None:
                        self._net_grad(q)
                    else:
                        graph.replay()
                with trace.span("train.adam", device=True):
                    for group in opt.param_groups:
                        group["lr"] = net_lr(self.cfg, n, epoch * n + i)
                    opt.step()

    def emb_update(self, epoch: int, q: int) -> None:
        """The once-per-epoch full-set embedding update (after the epoch's
        :meth:`net_steps`, which made the buffers)."""
        with trace.span("train.emb_update", device=True):
            if self.use_graphs:
                self._graphs_for(q)[1].replay()
            else:
                self._emb_grad(q)
            for group in self.state.emb_opt.param_groups:
                group["lr"] = emb_lr(self.cfg, epoch)
            self.state.emb_opt.step()

    def run(self, epoch: int, q: int, idx, mask) -> torch.Tensor:
        """One whole epoch; returns its metric rows on the device (a copy)."""
        with trace.span("train.epoch", request=epoch):
            self.noise.start_epoch(epoch, idx.shape[0])
            if self.shard is None:
                self.net_steps(epoch, q, idx, mask)
                self.emb_update(epoch, q)
                rows = self.rows.clone()
            else:
                dev = self.state.emb.device
                rows = _shard_net_steps(self.state, self.cfg, self.gt, self.dist, idx.to(dev).long(),
                                        mask.to(dev), self.n_total_pts, q, self.noise, epoch, self.shard)
                s = self.state
                s.emb.grad = emb_full_grad(s.net, self.cfg, s.emb, self.gt, self.dist, self.block_valid,
                                           self.n_total_pts, q, self.noise, shard=self.shard)
                for group in s.emb_opt.param_groups:
                    group["lr"] = emb_lr(self.cfg, epoch)
                s.emb_opt.step()
                s.emb.grad = None
        self.state.epoch = epoch
        return rows


def run_epoch(
    state: TrainState, cfg: TrainConfig, gt, dist, idx, mask, block_valid, n_total_pts: float,
    q: int, noise: NoiseSource, epoch: int, emb_chunks: int = 1, shard: Optional[Shard] = None,
    program: Optional[EpochProgram] = None,
) -> torch.Tensor:
    """One full epoch on ``state`` (in place): the net steps, then the
    embedding update. ``idx``/``mask`` are :func:`batch_plan`'s (host or
    device tensors). Returns the per-step metrics on the device; nothing is
    fetched here (a ``shard``'s rows are the rank's share, see
    :func:`_shard_net_steps`). ``program`` is the run's
    :class:`EpochProgram` over these same arguments (its buffers and CUDA
    graphs carry over from epoch to epoch); without one the epoch runs on a
    new eager program."""
    if program is None:
        program = EpochProgram(state, cfg, gt, dist, block_valid, n_total_pts, noise, emb_chunks, shard)
    return program.run(epoch, q, idx, mask)


@torch.no_grad()
def evaluate(net, cfg, emb, gt, dist, block_valid, n_total_pts, shard: Optional[Shard] = None) -> dict:
    """Full-set eval at q=2 rounded latents, no noise, f32 (reference
    ``NVFPCC.py:308-364``). Returns the metrics as host floats; with a
    ``shard``, the group's (every rank calls it)."""
    if shard is None:
        _, metrics = rd_loss(net, cfg, emb.detach(), gt, dist, block_valid, n_total_pts, "eval", 2)
        return dict(zip(METRIC_KEYS, _stack_metrics(metrics).cpu().numpy()))
    _, metrics = rd_loss(
        net, cfg, emb.detach(), gt, dist, block_valid, n_total_pts, "eval", 2,
        n_pts_override=torch.tensor(n_total_pts, dtype=torch.float32, device=emb.device),
        count_net=shard.mesh.rank == 0, acc_counts=True,
    )
    row = _reduce_rows(shard.mesh, _stack_metrics(metrics, MESH_METRIC_KEYS)[None])[0]
    return dict(zip(MESH_METRIC_KEYS, row))


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


# the epochs train(profile_dir=...) traces, first and last
PROFILE_EPOCHS = (3, 5)


def chunk_end(cfg: TrainConfig, e0: int, profile_pending: bool = False) -> int:
    """Last epoch (inclusive) of the chunk that starts at ``e0`` (the JAX
    package's ``train`` cadence, ``nvfpcc_tpu/train/loop.py:565-577``): the
    next eval/checkpoint epoch, the last epoch before the q phase change,
    the run's last epoch, whichever comes first; while a profile trace is
    pending (``profile_pending``), every epoch up to one past the window is
    a chunk of its own, so the window's edges stay on the host."""
    e1 = cfg.epochs - 1
    if cfg.eval_every > 0:
        e1 = min(e1, e0 + (-e0) % cfg.eval_every)  # first e >= e0 with e % eval_every == 0
    if e0 < cfg.phase_change:
        e1 = min(e1, cfg.phase_change - 1)
    if profile_pending and e0 <= PROFILE_EPOCHS[1] + 1:
        e1 = e0
    return e1


def _save_epoch(checkpoint_dir, epoch, state: TrainState, model_cfg, n_blocks, shard) -> None:
    """The per-epoch checkpoint (real blocks only) and the train-state
    snapshot. Under a mesh every rank gathers the embeddings and their Adam
    moments (the snapshot holds the padded axis) and rank 0 writes."""
    emb, emb_state = state.emb.detach(), None
    if shard is not None:
        st = state.emb_opt.state[state.emb]
        emb, mu, nu = (pm.gather_rows(shard.mesh, t, len(shard.block_pts))
                       for t in (emb, st["exp_avg"], st["exp_avg_sq"]))
        emb_state = (emb.cpu().numpy(), mu.cpu().numpy(), nu.cpu().numpy(), int(st["step"]))
        if shard.mesh.rank:
            return
    ckpt_util.save_checkpoint(
        checkpoint_dir, epoch, params_to_numpy(state.net), emb[:n_blocks].cpu().numpy(),
        meta=checkpoint_meta(model_cfg),
    )
    ckpt_util.save_train_state(checkpoint_dir, epoch, state, emb_state)


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
    mesh: Optional[pm.Mesh] = None,
    graphs: Optional[bool] = None,
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

    ``mesh`` runs this call as one rank of a block-DP group (every rank
    calls ``train`` with the same arguments and its own ``device``): the
    block axis is padded to a multiple of the world size, the rank keeps its
    rows on the device, and rank 0 alone logs, writes the metrics and the
    checkpoints, and profiles. The returned embeddings are all the real
    blocks' on every rank; the returned embedding Adam holds the rank's rows.

    The run goes in chunks of epochs (:func:`chunk_end`, the JAX package's
    cadence): a chunk ends at the next eval and checkpoint epoch, before
    the q phase change, at the run's end, and after each epoch of the
    profile window. The chunk's metric rows are fetched once, after its
    last epoch; then each epoch's metrics line and log line are written
    (the log's seconds are the chunk's over its epochs) and a non-finite
    loss raises :class:`TrainDivergence`. ``graphs`` runs the steps as CUDA
    graphs (:class:`EpochProgram`): None means on exactly when ``device``
    is CUDA, there is no ``mesh`` and the noise is the default
    :class:`NoiseSource`; True anywhere else raises.
    """
    device = torch.device(device)
    set_train_numerics()
    n_blocks = int(gt.shape[0])
    n_total_pts = float(gt.sum())
    spec = M.build_model_spec(
        model_cfg.ch, model_cfg.channels, model_cfg.seed_tag, model_cfg.entropy_mode,
        model_cfg.ctx_detach_pred, model_cfg.ctx_hidden, ctx_tail=model_cfg.ctx_tail,
    )
    if mesh is not None and mesh.rank:
        log, metrics_path, profile_dir = (lambda s: None), None, None

    if mesh is not None:
        # the ranks already split the full-set update; no chunking on top
        emb_chunks = 1
        n_padded = pm.padded_block_count(n_blocks, mesh.world)
    else:
        emb_chunks = resolve_emb_chunks(cfg.emb_chunks, n_blocks)
        n_padded = n_blocks + (-n_blocks) % emb_chunks
    gt, dist = pm.pad_blocks(np.asarray(gt), n_padded), pm.pad_blocks(np.asarray(dist), n_padded)
    valid = np.concatenate([np.ones(n_blocks, np.float32), np.zeros(n_padded - n_blocks, np.float32)])
    shard = None
    if mesh is not None:
        shard = Shard(mesh, n_blocks, gt.reshape(n_padded, -1).sum(1, dtype=np.int64))
        gt, dist, valid = pm.shard_train_arrays(mesh, gt, dist, valid)
    block_valid = torch.as_tensor(valid, device=device)
    gt_d, dist_d = _prep_dense(gt, dist, device)

    net = initial_params(spec, model_cfg, device)
    emb = M.init_embeddings(block_valid.shape[0], model_cfg.ch, device).requires_grad_(True)
    opt, emb_opt = make_optimizers(cfg, net, emb)
    state = TrainState(net, opt, emb, emb_opt)
    graph_ok = device.type == "cuda" and mesh is None and (noise is None or type(noise) is NoiseSource)
    if graphs and not graph_ok:
        raise ValueError("train(graphs=True) needs a CUDA device, no mesh and the default NoiseSource "
                         f"(device {device.type}, mesh {mesh is not None}, noise {type(noise).__name__})")
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
                    "(mesh size changed since the snapshot? or another cloud or chunking)"
                )
            if shard is not None:  # every rank reads the file and keeps its rows
                e = snap["emb_opt"]
                snap["emb"], e["exp_avg"], e["exp_avg_sq"] = (
                    a[shard.rows] for a in (snap["emb"], e["exp_avg"], e["exp_avg_sq"]))
            ckpt_util.restore_train_state(state, snap)
            start_epoch = snap["epoch"] + 1
            log(f"[train] resumed from {snap_path} (epoch {snap['epoch']})")
    if mesh is not None:
        pm.replicate(mesh, net)
    keys = METRIC_KEYS if mesh is None else MESH_METRIC_KEYS
    reduce_ms = []

    program = EpochProgram(state, cfg, gt_d, dist_d, block_valid, n_total_pts, noise, emb_chunks, shard,
                           graph_ok if graphs is None else graphs)

    prof_dir, profiler = profile_dir, None

    def write_profile():
        profiler.stop()
        os.makedirs(prof_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(prof_dir, "train_trace.json"))
        log(f"[train] profiler trace written to {prof_dir}")

    epoch = start_epoch
    while epoch < cfg.epochs:
        e0, e1 = epoch, chunk_end(cfg, epoch, prof_dir is not None)
        if prof_dir is not None and e0 == PROFILE_EPOCHS[0]:
            profiler = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA] if device.type == "cuda" else [])
            )
            profiler.start()
        t0 = time.time()
        q = 1 if e0 < cfg.phase_change else 2
        chunk = []
        for e in range(e0, e1 + 1):
            idx, mask = batch_plan(n_blocks, cfg.batch_size, cfg.shuffle, cfg.seed, e)
            chunk.append(run_epoch(
                state, cfg, gt_d, dist_d, torch.from_numpy(idx).long(), torch.from_numpy(mask), block_valid,
                n_total_pts, q, noise, e, emb_chunks, shard, program=program,
            ))
        # the one fetch of the chunk; it also waits for the device
        stacked = torch.cat(chunk)
        stacked = stacked.cpu().numpy() if shard is None else _reduce_rows(mesh, stacked)
        chunk_s = (time.time() - t0) / (e1 - e0 + 1)
        if mesh is not None:
            reduce_ms += mesh.timed_ms()
        if profiler is not None and e0 >= PROFILE_EPOCHS[1]:
            write_profile()
            profiler, prof_dir = None, None
        for e, rows in zip(range(e0, e1 + 1), stacked.reshape(e1 - e0 + 1, -1, stacked.shape[-1])):
            s = summarize_metrics({k: rows[:, j] for j, k in enumerate(keys)})
            if not np.isfinite(s["loss"]):
                raise TrainDivergence(f"non-finite loss at epoch {e} (q={q}): {s}")
            if metrics_path is not None:
                with open(metrics_path, "a") as f:
                    f.write(json.dumps({"epoch": e, "q": q, **s}) + "\n")
            log(
                f"[Epoch {e:04d} TRAIN {chunk_s:.1f}s] "
                f"Loss: {s['loss']:.4e} Pacc: {s['pacc']:.4f} Nacc: {s['nacc']:.4f} "
                f"S1: {s['ms0']:.1f} S2: {s['ms1']:.1f} bpp: {s['bpp']:.4f} "
                f"b_latent: {s['b_latent']:.4f} b_net: {s['b_net']:.4f} "
                f"MSE1: {s['mse1']:.4f} PSNR1: {s['psnr1']:.4f}"
            )

        epoch = e1 + 1
        if cfg.eval_every > 0 and e1 % cfg.eval_every == 0:
            es = summarize_metrics(
                evaluate(net, cfg, state.emb, gt_d, dist_d, block_valid, n_total_pts, shard)
            )
            if es.get("lat_amax", 0.0) > LATENT_GUARD and (mesh is None or not mesh.rank):
                warnings.warn(
                    f"epoch {e1}: max |rounded latent| = {es['lat_amax']:.0f} "
                    f"is approaching the coder alphabet edge (512); encode "
                    "will clamp (rate loss). Consider a larger lambda*w1 or "
                    "checking for divergence."
                )
            log(
                f"[Epoch {e1:04d} TEST] Loss: {es['loss']:.4e} "
                f"Pacc: {es['pacc']:.4f} Nacc: {es['nacc']:.4f} bpp: {es['bpp']:.4f} "
                f"b_latent: {es['b_latent']:.4f} b_net: {es['b_net']:.4f} "
                f"MSE1: {es['mse1']:.4f} PSNR1: {es['psnr1']:.4f}"
            )
            if checkpoint_dir is not None:
                _save_epoch(checkpoint_dir, e1, state, model_cfg, n_blocks, shard)

    if profiler is not None:  # the run ended inside the window
        write_profile()
    if mesh is not None:
        bucket = 4 * sum(p.numel() for p in net.parameters())
        ms = np.asarray(reduce_ms if reduce_ms else [np.nan])
        log(
            f"[train] block-DP over {mesh.world} ranks ({mesh.backend}, {mesh.device.type}): "
            f"{len(reduce_ms)} gradient all-reduces of {bucket} bytes, one per net step; "
            f"{np.median(ms):.3f} ms median, {ms.mean():.3f} ms mean per step on rank 0"
        )
        emb_all = pm.gather_rows(mesh, state.emb, n_padded)[:n_blocks]
        state = TrainState(net, opt, emb_all, emb_opt, state.epoch)
    elif n_padded != n_blocks:  # strip the chunk padding from the returned embeddings
        state = TrainState(net, opt, state.emb.detach()[:n_blocks], emb_opt, state.epoch)
    return spec, state


def train_on_mesh(mesh: pm.Mesh, jobs: list, echo: bool = False) -> list:
    """Run :func:`train` on this rank of ``mesh`` once per entry of ``jobs``
    (each a dict of train's keyword arguments: ``gt``, ``dist``,
    ``model_cfg``, ``cfg`` and any of ``checkpoint_dir``, ``resume``,
    ``metrics_path``, ``profile_dir``), in order. It is the function
    ``parallel.run_group`` starts on every rank. ``echo`` prints rank 0's
    log as it comes. Returns per job rank 0's log lines, the params tree
    and all real blocks' embeddings (numpy) and the seconds it took."""
    out = []
    for job in jobs:
        lines = []

        def log(line, lines=lines):
            lines.append(line)
            if echo:
                print(line, flush=True)

        t0 = time.time()
        _, state = train(device=mesh.device, log=log, mesh=mesh, **job)
        out.append({"log": lines, "params": params_to_numpy(state.net),
                    "emb": state.emb.detach().cpu().numpy(), "seconds": time.time() - t0})
    return out
