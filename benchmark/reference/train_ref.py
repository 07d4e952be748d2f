"""The reference side of a training cell's check.

- :func:`follow_steps`: from the fit's start, the first net steps of the
  first epoch on the configuration's batch plan, with the noise stream the
  configuration defines: each step's loss, the first step's gradient, and
  each leaf's change over the steps.
- :func:`full_set_emb_grad`: the gradient of the full-set embedding loss
  at given parameters and embeddings, in blocks of rows (every term is a
  sum over blocks and the latent rate divides by the whole set's point
  count, so the blocks' gradients concatenate to the whole one), drawing
  the update's noise after the epoch's net-step draws, one draw per chunk
  of the configured embedding chunks.
- :func:`epoch_steps`: one later epoch step by step, each step from the
  program's own state before it (parameters, Adam moments and count):
  the step's loss, gradient and Adam change, then the embedding update's
  gradient and Adam change. It cannot follow such an epoch from the start
  of the fit: a residual that crosses a rounding edge of the 1/16 grid a
  step earlier on one side moves the effective kernel by 1/16, and such
  crossings build up over the fit's steps.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.nvfpcc import Adam, Forward, Model, NoiseStream, adam_update, rd_loss


def batch_plan(n_blocks: int, batch: int):
    """The configuration's plan: the stride pseudo-shuffle ``i * 2113 mod
    N`` cut into batches, the last padded with block 0 under mask 0."""
    perm = (np.arange(n_blocks, dtype=np.int64) * 2113) % n_blocks
    n_b = -(-n_blocks // batch)
    pad = n_b * batch - n_blocks
    idx = np.concatenate([perm, np.zeros(pad, np.int64)]).reshape(n_b, batch)
    mask = np.concatenate([np.ones(n_blocks, np.float32), np.zeros(pad, np.float32)]).reshape(n_b, batch)
    return idx, mask


def _latent_shape(cfg, rows):
    return (rows, 2, 2, 2, cfg["ch"])


def _decayed(tcfg: dict, base: float, epoch: int) -> float:
    """``base`` decayed at each of the configuration's milestones (epochs)
    that ``epoch`` has reached (MultiStepLR)."""
    return base * tcfg["lr_decay"] ** sum(epoch >= m for m in tcfg["milestones"])


def net_lr(tcfg: dict, epoch: int) -> float:
    return _decayed(tcfg, tcfg["lr"], epoch)


def emb_lr(tcfg: dict, epoch: int) -> float:
    return _decayed(tcfg, tcfg["lr"] * tcfg["wemb"], epoch)


def follow_steps(cfg: dict, gt, dist, noise_seed: int, steps: int, precision: str, half_batch: bool = False):
    """Reference losses, first gradient and changes of the first ``steps``
    net steps. ``gt`` (N, 32, 32, 32) uint8, ``dist`` float32, on the
    device. ``half_batch`` plants the fault that leaves half of each batch
    out and scales the rest to the batch (a control, never a check)."""
    dev = gt.device
    tcfg = cfg["train"]
    model = Model(cfg, dev)
    fw = Forward(model, precision)
    p = model.initial_params()
    p0 = {k: v.detach().clone() for k, v in p.items()}
    emb = torch.ones(_latent_shape(cfg, gt.shape[0]), device=dev)
    adam = Adam(p, net_lr(tcfg, 0))
    idx, mask = batch_plan(gt.shape[0], tcfg["batch_size"])
    noise = NoiseStream(noise_seed, dev)
    noise.start_epoch(0)
    n_total = float(gt.sum())
    keys = list(p)
    losses, grad1 = [], None
    for i in range(steps):
        b = torch.as_tensor(idx[i], device=dev)
        m = torch.as_tensor(mask[i], device=dev)
        nz = noise.draw(_latent_shape(cfg, len(b)), model.ctx)
        if half_batch:
            m = m * (torch.arange(len(b), device=dev) < len(b) // 2)
        loss = rd_loss(fw, p, emb[b], gt[b].float()[..., None], dist[b][..., None], m, n_total, tcfg, nz)
        if half_batch:
            loss = loss * 2.0
        grads = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g for k, g in zip(keys, grads)}
        if i == 0:
            grad1 = {k: g.detach().clone() for k, g in grads.items()}
        adam.step(p, grads)
        losses.append(float(loss.detach()))
    change = {k: (p[k] - p0[k]).detach() for k in keys}
    return {"losses": losses, "grad1": grad1, "change": change, "params": {k: v.detach() for k, v in p.items()}}


def full_set_emb_grad(cfg: dict, params: dict, gt, dist, noise_seed: int, precision: str, block: int = 256,
                      half_batch: bool = False, emb=None, epoch: int = 0):
    """The embedding gradient (N, 2, 2, 2, ch) of epoch ``epoch``'s update
    at ``params`` (leaf -> tensor, format paths) and embeddings ``emb``
    (ones, the fit's start, when None)."""
    dev = gt.device
    tcfg = cfg["train"]
    model = Model(cfg, dev)
    fw = Forward(model, precision)
    p = {k: v.detach().to(dev) for k, v in params.items()}
    n = gt.shape[0]
    chunks = int(tcfg["emb_chunks"])
    if n % chunks:
        raise ValueError("the block count must be a multiple of the embedding chunks")
    noise = NoiseStream(noise_seed, dev)
    noise.start_epoch(epoch)
    n_batches = -(-n // tcfg["batch_size"])
    for _ in range(n_batches):  # the net steps' draws come first
        noise.draw(_latent_shape(cfg, tcfg["batch_size"]), model.ctx)
    n_pts = gt.reshape(n, -1).sum(1).float().sum()
    n_total = float(n_pts)
    out = []
    per = n // chunks
    for c in range(chunks):
        nz = noise.draw(_latent_shape(cfg, per), model.ctx)
        for s in range(c * per, (c + 1) * per, block):
            e = min(s + block, (c + 1) * per)
            rows = (torch.ones(_latent_shape(cfg, e - s), device=dev) if emb is None else emb[s:e].detach().clone())
            rows.requires_grad_(True)
            sub = {k: v[s - c * per:e - c * per] for k, v in nz.items()}
            m = torch.ones(e - s, device=dev)
            if half_batch:
                m = m * (torch.arange(s, e, device=dev) < n // 2)
            loss = rd_loss(fw, p, rows, gt[s:e].float()[..., None], dist[s:e][..., None], m, n_total, tcfg, sub,
                           n_pts=n_pts)
            g = torch.autograd.grad(loss * (2.0 if half_batch else 1.0), rows)[0]
            out.append(g.detach())
    return torch.cat(out)


def epoch_steps(cfg: dict, gt, dist, noise_seed: int, epoch: int, rec: dict, precision: str,
                half_batch: bool = False) -> dict:
    """The reference's side of a recorded epoch ``epoch``. ``rec`` is the
    program's state before each step: ``steps``, a list of ``{"theta",
    "m", "v"}`` (leaf -> tensor) and ``"t"`` (the net Adam's earlier
    steps), one per net step the program took (the reference takes as
    many, at most one per batch of the plan); ``theta_end``, the net
    parameters the update starts from; ``emb``, ``emb_m``, ``emb_v``,
    ``emb_t``, the embeddings and their Adam before the update. Returns
    ``losses``, ``grads`` and ``changes`` (one per step), ``emb_grad`` and
    ``emb_change``; ``half_batch`` plants that fault (a control)."""
    dev = gt.device
    tcfg = cfg["train"]
    model = Model(cfg, dev)
    fw = Forward(model, precision)
    idx, mask = batch_plan(gt.shape[0], tcfg["batch_size"])
    noise = NoiseStream(noise_seed, dev)
    noise.start_epoch(epoch)
    n_total = float(gt.sum())
    lr = net_lr(tcfg, epoch)
    emb = rec["emb"]
    out = {"losses": [], "grads": [], "changes": []}
    for i, st in enumerate(rec["steps"][:len(idx)]):
        b = torch.as_tensor(idx[i], device=dev)
        m = torch.as_tensor(mask[i], device=dev)
        nz = noise.draw(_latent_shape(cfg, len(b)), model.ctx)
        if half_batch:
            m = m * (torch.arange(len(b), device=dev) < len(b) // 2)
        p = {k: v.detach().clone().requires_grad_(True) for k, v in st["theta"].items()}
        loss = rd_loss(fw, p, emb[b], gt[b].float()[..., None], dist[b][..., None], m, n_total, tcfg, nz)
        if half_batch:
            loss = loss * 2.0
        keys = list(p)
        grads = torch.autograd.grad(loss, [p[k] for k in keys], allow_unused=True)
        grads = {k: torch.zeros_like(p[k]) if g is None else g.detach() for k, g in zip(keys, grads)}
        out["losses"].append(float(loss.detach()))
        out["grads"].append(grads)
        out["changes"].append({k: adam_update(grads[k], st["m"][k], st["v"][k], st["t"], lr)[0] for k in keys})
    g = full_set_emb_grad(cfg, rec["theta_end"], gt, dist, noise_seed, precision, half_batch=half_batch, emb=emb,
                          epoch=epoch)
    out["emb_grad"] = g
    out["emb_change"] = adam_update(g, rec["emb_m"], rec["emb_v"], rec["emb_t"], emb_lr(tcfg, epoch))[0]
    return out
