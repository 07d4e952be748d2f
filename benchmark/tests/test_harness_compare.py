"""The numbers that decide ``correct``, on inputs written by hand."""

import math

import numpy as np
import pytest
import torch

from benchmark.reference.compare import epoch_numbers, moving_leaves, point_gap, train_numbers, worst_leaf_gap

ORIGINS = np.array([[0, 0, 0], [0, 0, 32], [32, 0, 0]])


def occupancy():
    occ = np.zeros((3, 32, 32, 32), np.float32)
    occ[0, 1, 2, 3] = 0.9
    occ[2, 5, 5, 5] = 0.7
    occ[1, 0, 0, 0] = 0.5000001
    return occ


def test_point_gap():
    occ, right = occupancy(), np.array([[1, 2, 3], [0, 0, 32], [37, 5, 5]])
    assert point_gap(right, ORIGINS, occ, 0.5)[0] == 0.0
    # a voxel just over the threshold left out reads its small gap
    assert point_gap(right[[0, 2]], ORIGINS, occ, 0.5)[0] == pytest.approx(1e-7, abs=1e-7)
    assert point_gap(right[[1, 2]], ORIGINS, occ, 0.5)[0] == pytest.approx(0.4)
    # outside every block, or the same point twice: infinite
    assert math.isinf(point_gap(np.array([[0, 31, -1]]), ORIGINS, occ, 0.5)[0])
    assert math.isinf(point_gap(np.array([[64, 0, 0]]), ORIGINS, occ, 0.5)[0])
    assert math.isinf(point_gap(right[[0, 0, 1, 2]], ORIGINS, occ, 0.5)[0])


def test_leaf_gaps():
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0]), "c": torch.tensor([0.0, 0.0])}
    prog = {"a": torch.tensor([3.0, 4.5]), "b": torch.tensor([-1.0]), "c": torch.tensor([0.01, 0.0])}
    gap, leaf = worst_leaf_gap(prog, ref)  # norms 5, 1, 0; median 1
    assert leaf == "a" and gap == pytest.approx((np.hypot(3, 4.5) - 5) / 5)
    assert worst_leaf_gap(prog, ref, ["b", "c"]) == (pytest.approx(0.01 / 0.5), "c")
    assert sorted(moving_leaves(ref)) == ["a", "b"]
    unchanged = train_numbers({"losses": [1.0], "grad1": prog, "change": {k: 0 * v for k, v in ref.items()},
                               "emb_grad": torch.ones(4)},
                              {"losses": [1.0], "grad1": ref, "change": ref, "emb_grad": torch.ones(4)})
    assert unchanged["change_gap"] == 1.0 and unchanged["loss_gap"] == 0.0 and unchanged["emb_grad_gap"] == 0.0


def test_epoch_numbers():
    ref_g = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([1.0])}
    ref = {"losses": [2.0, 2.0], "grads": [ref_g, ref_g], "changes": [ref_g, ref_g],
           "emb_grad": torch.ones(4), "emb_change": torch.ones(4)}
    sound = {**ref, "steps": 2, "adam_steps": 2.0}
    numbers = epoch_numbers(sound, ref, 2)
    numbers.pop("_worst")
    assert numbers == {"epoch_steps": 0.0, "epoch_loss_gap": 0.0, "epoch_grad_gap": 0.0, "epoch_change_gap": 0.0,
                       "epoch_emb_grad_gap": 0.0, "epoch_emb_change_gap": 0.0}
    # one step taken of two: the steps read 1, and only the step taken is compared
    short = {**sound, "losses": [2.0], "grads": [ref_g], "changes": [ref_g], "steps": 1, "adam_steps": 1.0}
    assert epoch_numbers(short, ref, 2)["epoch_steps"] == 1.0
    # a stale second gradient, a doubled second change, no embedding update
    stale = {**sound, "losses": [2.0, 2.2], "grads": [ref_g, {"a": ref_g["a"], "b": torch.tensor([3.0])}],
             "changes": [ref_g, {k: 2 * v for k, v in ref_g.items()}], "emb_grad": None, "emb_change": None}
    got = epoch_numbers(stale, ref, 2)
    assert got["epoch_loss_gap"] == pytest.approx(0.1) and got["epoch_grad_gap"] == pytest.approx(2 / 3)  # over the median norm, 3
    assert got["epoch_change_gap"] == pytest.approx(1.0) and got["_worst"]["epoch_grad_gap"] == (1, "b")
    assert math.isinf(got["epoch_emb_grad_gap"]) and math.isinf(got["epoch_emb_change_gap"])
