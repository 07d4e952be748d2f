"""The numbers that decide ``correct``: each compares what the program's
timed path produced with what the reference works out, and each has a
limit of its own (``benchmark/limits/<cell>.json``).

Training (by the worst leaf, leaves named by the checkpoint format's
paths):

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss over the first net steps;
- ``grad_gap``: the first net step's gradient as the program's Adam got it
  (its first moment after one step over 1 - beta1), the gap between the
  program's and the reference's norm of a leaf over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``change_gap``: the same gap for each leaf's change over the first net
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (the others move under Adam by round-off alone);
- ``emb_grad_gap``: the relative gap between the norms of the full-set
  embedding gradient (the embedding Adam's first moment after its first
  step over 1 - beta1) and the reference's.

A later epoch, step by step from the program's own state before each
step (``epoch_numbers``):

- ``epoch_steps``: how far the net steps the program took, and the net
  Adam's count over the epoch, are from one a batch of the plan (0 when
  both are);
- ``epoch_loss_gap``: the largest relative gap of a step's loss, as the
  program's metric row has it;
- ``epoch_grad_gap``: the largest over the steps of the worst leaf's gap
  of the gradient as the program's Adam got it (its ``.grad``);
- ``epoch_change_gap``: the same for each step's change, against the
  reference's Adam step from the program's moments, over the leaves that
  move (as ``change_gap``);
- ``epoch_emb_grad_gap`` and ``epoch_emb_change_gap``: the relative gaps
  of the norms of the embedding update's gradient and change.

Decode: ``point_gap``, the widest gap between the reference's occupancy
and the threshold over the voxels where the program's points and the
reference's decisions differ; a point outside every block, or twice, is
an infinite gap.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch


def leaf_norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tree.items()}


def worst_leaf_gap(prog: dict, ref: dict, keys=None):
    """(gap, leaf): the largest ``|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    keys = sorted(ref) if keys is None else sorted(keys)
    pn, rn = leaf_norms({k: prog[k] for k in keys}), leaf_norms({k: ref[k] for k in keys})
    med = statistics.median(rn.values())
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med) if max(rn[k], med) > 0 else math.inf for k in keys}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moving_leaves(ref_grad: dict) -> list:
    """The leaves whose reference gradient norm is at least a thousandth of
    the median leaf's."""
    n = leaf_norms(ref_grad)
    med = statistics.median(n.values())
    return [k for k, v in n.items() if v >= 1e-3 * med]


def _norm_gap(prog, ref) -> float:
    if prog is None:
        return math.inf
    p, r = float(torch.linalg.vector_norm(prog.double())), float(torch.linalg.vector_norm(ref.double()))
    return abs(p - r) / r if r > 0 else math.inf


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (the first steps'),
    ``grad1`` (leaf -> first gradient), ``change`` (leaf -> change over the
    steps) and ``emb_grad`` (the full-set embedding gradient)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    if len(losses) != len(ref["losses"]) or not all(math.isfinite(x) for x in losses):
        losses = [math.inf]
    grad_gap, grad_leaf = worst_leaf_gap(prog["grad1"], ref["grad1"])
    change_gap, change_leaf = worst_leaf_gap(prog["change"], ref["change"], moving_leaves(ref["grad1"]))
    return {
        "loss_gap": max(losses),
        "grad_gap": grad_gap,
        "change_gap": change_gap,
        "emb_grad_gap": _norm_gap(prog["emb_grad"], ref["emb_grad"]),
        "_worst": {"grad_gap": grad_leaf, "change_gap": change_leaf},
    }


def epoch_numbers(prog: dict, ref: dict, n_batches: int) -> dict:
    """``prog`` holds the program's ``losses``, ``grads`` and ``changes``
    (one per step it took), ``steps`` and ``adam_steps`` (its net steps
    and the net Adam's count over the epoch), ``emb_grad`` and
    ``emb_change`` (None when the update did not run); ``ref`` what
    :func:`benchmark.reference.train_ref.epoch_steps` returns."""
    k = min(len(prog["grads"]), len(ref["grads"]))
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"][:k], ref["losses"][:k])]
    if not k or not all(math.isfinite(x) for x in losses):
        losses = [math.inf]
    grad = [worst_leaf_gap(prog["grads"][i], ref["grads"][i]) for i in range(k)] or [(math.inf, None)]
    change = [worst_leaf_gap(prog["changes"][i], ref["changes"][i], moving_leaves(ref["grads"][i]))
              for i in range(k)] or [(math.inf, None)]
    gi = max(range(len(grad)), key=lambda i: grad[i][0])
    ci = max(range(len(change)), key=lambda i: change[i][0])
    return {
        "epoch_steps": float(max(abs(prog["steps"] - n_batches), abs(prog["adam_steps"] - n_batches))),
        "epoch_loss_gap": max(losses),
        "epoch_grad_gap": grad[gi][0],
        "epoch_change_gap": change[ci][0],
        "epoch_emb_grad_gap": _norm_gap(prog["emb_grad"], ref["emb_grad"]),
        "epoch_emb_change_gap": _norm_gap(prog["emb_change"], ref["emb_change"]),
        "_worst": {"epoch_grad_gap": (gi, grad[gi][1]), "epoch_change_gap": (ci, change[ci][1])},
    }


def point_gap(points: np.ndarray, origins: np.ndarray, occ_ref: np.ndarray, thh: float, block: int = 32):
    """(gap, voxels that differ) of one decode's points (M, 3) against the
    reference occupancy (N, B, B, B) of blocks at ``origins`` (N, 3), at
    threshold ``thh`` (compared in float32, as the decoder compares)."""
    n = len(origins)
    pts = np.asarray(points, np.int64).reshape(-1, 3)
    org = np.asarray(origins, np.int64)
    t = np.float32(thh)
    base = pts - pts % block
    width = int(max(org.max(initial=0), base.max(initial=0))) // block + 1
    okey = ((org[:, 0] // block) * width + org[:, 1] // block) * width + org[:, 2] // block
    order = np.argsort(okey)
    pkey = ((base[:, 0] // block) * width + base[:, 1] // block) * width + base[:, 2] // block
    pos = np.searchsorted(okey[order], pkey)
    pos = np.minimum(pos, n - 1)
    blk = order[pos]
    loc = pts - org[blk]
    if len(pts) and (not np.array_equal(okey[blk], pkey) or loc.min() < 0 or loc.max() >= block):
        return math.inf, -1  # a point outside every block
    ids = ((blk * block + loc[:, 0]) * block + loc[:, 1]) * block + loc[:, 2]
    prog = np.zeros(n * block**3, bool)
    prog[ids] = True
    if int(prog.sum()) != len(pts):
        return math.inf, -1  # a point twice
    occ = np.asarray(occ_ref, np.float32).reshape(-1)
    diff = prog ^ (occ > t)
    if not diff.any():
        return 0.0, 0
    return float(np.abs(occ[diff].astype(np.float64) - float(t)).max()), int(diff.sum())
