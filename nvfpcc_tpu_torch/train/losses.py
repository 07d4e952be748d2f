"""Losses and metrics on dense occupancy grids, channels-last (port of
``nvfpcc_tpu/train/losses.py``).

- ``focal_dense``       — focal BCE on probabilities.
- ``surf_focal_dense``  — distance-weighted focal: weight = dist + mask*beta,
  the main 'wfocal' loss.
- ``acc_dense``         — pos/neg accuracy at a threshold (``acc_counts``:
  its counts, which add across block shards).
- ``sse1``              — SSE of the distance field over predicted-occupied
  voxels + count; feeds MSE1/PSNR1.
- ``multiscale_gt``     — max-pool GT pyramid [8^3, 16^3, 32^3].

All reductions are un-normalized sums in f32. The optional per-block
``block_mask`` (B,) removes the padding rows of a padded batch from every
term.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _apply_block_mask(x, block_mask):
    if block_mask is None:
        return x
    return x * block_mask.reshape((-1,) + (1,) * (x.ndim - 1))


def _focal_terms(pred, gt, alpha: float, gamma: float):
    """(alphas * (1 - prob)^gamma, log prob) with prob = p where occupied,
    1 - p where empty."""
    mask = gt.bool()
    sign = torch.where(mask, 1.0, -1.0)
    offs = torch.where(mask, 0.0, 1.0)
    prob = pred * sign + offs
    alphas = alpha * sign + offs
    prob = torch.clamp_min(prob, 1e-9)
    return -alphas * (1.0 - prob) ** gamma, torch.log(prob)


def focal_dense(pred, gt, alpha: float = 0.97, gamma: float = 2.0, block_mask=None):
    """Focal BCE on dense probability grids (reference ``get_focal_dense``)."""
    w, logp = _focal_terms(pred, gt, alpha, gamma)
    return _apply_block_mask(w * logp, block_mask).sum()


def surf_focal_dense(
    pred, gt, dist, beta: float = 1.0, alpha: float = 0.97, gamma: float = 2.0, block_mask=None
):
    """Distance-weighted focal loss (reference ``get_surf_focal_dense``):
    empty voxels are weighted by their distance to the surface, occupied
    voxels (dist == 0) by ``beta``."""
    w, logp = _focal_terms(pred, gt, alpha, gamma)
    dist_w = dist + gt.bool() * beta
    return _apply_block_mask(w * dist_w * logp, block_mask).sum()


def acc_counts(pred, gt, thh: float = 0.5, block_mask=None):
    """(true positives, positives, true negatives, negatives) at a threshold,
    as int64 sums. Padded blocks count in none of them. Counts add across
    block shards where the ratios of :func:`acc_dense` do not."""
    mask = gt.bool()
    imask = ~mask
    if block_mask is not None:
        bm = block_mask.reshape((-1,) + (1,) * (gt.ndim - 1)).bool()
        mask = mask & bm
        imask = imask & bm
    return ((pred > thh) & mask).sum(), mask.sum(), ((pred <= thh) & imask).sum(), imask.sum()


def acc_ratios(tp, ap, tn, an):
    """(positive, negative) accuracy from :func:`acc_counts`; an empty
    denominator gives accuracy 1, not nan."""
    one = torch.ones((), device=tp.device)
    return (
        torch.where(ap > 0, tp.float() / ap.clamp_min(1).float(), one),
        torch.where(an > 0, tn.float() / an.clamp_min(1).float(), one),
    )


def acc_dense(pred, gt, thh: float = 0.5, block_mask=None):
    """(positive, negative) accuracy at a threshold (reference
    ``get_acc_dense``). Padded blocks count in neither numerator nor
    denominator; an empty denominator gives accuracy 1, not nan."""
    return acc_ratios(*acc_counts(pred, gt, thh, block_mask))


def sse1(pred, gt, dist, thh: float, block_mask=None):
    """(sum of squared distances over predicted-occupied voxels, count)
    (reference ``get_sse1``). MSE1 = sse/denom; PSNR1 = 20*log10(1023/sqrt(MSE1/3))."""
    occupied = _apply_block_mask((pred > thh).float(), block_mask)
    return torch.square(occupied * dist).sum(), occupied.sum()


def psnr1_from_sse(sse_total: float, denom_total: float, maxv: float = 1023.0) -> float:
    """D1-proxy PSNR from accumulated sse1 terms, in f32 like the original."""
    mse1 = np.float32(sse_total / denom_total)
    with np.errstate(divide="ignore"):
        return float(np.float32(20.0) * np.log10(np.float32(maxv) / np.sqrt(mse1 / np.float32(3.0))))


def multiscale_gt(gt):
    """GT pyramid [8^3, 16^3, 32^3] via 2x max-pool twice (reference
    ``MultiscaleProcessor``). ``gt`` is (B, 32, 32, 32, 1) channels-last."""

    def pool(x):
        return F.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2).permute(0, 2, 3, 4, 1)

    x1 = pool(gt)
    x2 = pool(x1)
    return [x2, x1, gt]
