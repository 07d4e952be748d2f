"""The comparison that decides ``correct``, on the CPU at small sizes:
sound runs of the program come out correct, the control (the reference in
the precision below the configuration's) and runs with the timed path
broken underneath come out not correct, under the cells' limits."""

import copy

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.harness import Registry
from benchmark.run import execute

INFO = {"platform": "cpu", "kind": "cpu", "count": 1, "card": "cpu"}
N_BLOCKS = 48


def small(reg, name, n_blocks=N_BLOCKS):
    """The cell at ``n_blocks`` blocks, keeping its share of occupied voxels."""
    cell = reg.cell(name)
    cfg = copy.deepcopy(reg.config(cell["config"]))
    share = cfg["n_points"] / (cfg["n_blocks"] * 32**3)
    cfg["n_blocks"], cfg["n_points"] = n_blocks, round(n_blocks * 32**3 * share)
    return cell, cfg


def run_small(name, seed=2**33 + 17, trace=False, n_blocks=N_BLOCKS):
    reg = Registry()
    cell, cfg = small(reg, name, n_blocks)
    rc, line = execute(reg, cell, seed, 0.5, trace, torch.device("cpu"), config=cfg, info=INFO)
    assert rc == 0
    return line


@pytest.fixture(autouse=True)
def threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["train.flagship_vox10", "train.ctx_vox11", "decode.flagship_vox10"])
def test_sound_runs_are_correct(name):
    line = run_small(name, trace=name.startswith("decode"))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0


def test_control_fails_its_cells():
    reg = Registry()
    for name in ("train.flagship_vox10", "train.ctx_vox11", "decode.flagship_vox10"):
        cell, cfg = small(reg, name)
        limits = reg.limits(name)
        for seed in (3, 2**40 + 1):
            if name.startswith("train"):
                numbers = control.train_readings(cfg, seed, torch.device("cpu"))
            else:
                numbers = {k: {"point_gap": v} for k, v in
                           control.decode_readings(cfg, reg.traffic(cell["traffic"]), seed, "cpu").items()}
            for kind, values in numbers.items():
                over = [k for k in limits if k in values and values[k] > limits[k]]
                assert not over if kind == "program" else over, (name, seed, kind, values)


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line = run_small("train.flagship_vox10")
    assert not line["correct"] and line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from nvfpcc_tpu_torch.train import loop

    rd_loss = loop.rd_loss

    def half(net, cfg, emb_b, gt_b, dist_b, block_mask, *a, **kw):
        keep = (torch.arange(emb_b.shape[0], device=emb_b.device) < emb_b.shape[0] // 2).float()
        loss, metrics = rd_loss(net, cfg, emb_b, gt_b, dist_b, block_mask * keep, *a, **kw)
        return loss * 2.0, {**metrics, "loss": metrics["loss"] * 2.0}

    monkeypatch.setattr(loop, "rd_loss", half)
    for name in ("train.flagship_vox10", "train.ctx_vox11"):
        assert not run_small(name)["correct"]


def _net_steps(keep, grad_of):
    """A broken ``EpochProgram.net_steps``: after the first epoch it takes
    only the steps ``keep(i, n)`` and a step's gradient from row
    ``grad_of(i)`` of the plan's steps already run (a stale gradient when
    that is not ``i``)."""
    from nvfpcc_tpu_torch.train import loop

    def net_steps(self, epoch, q, idx, mask):
        self._load_plan(idx, mask)
        n, opt = self.idx.shape[0], self.state.opt
        for i in range(n):
            if epoch and not keep(i, n):
                continue
            if not epoch or grad_of(i) == i:
                self.i.fill_(i)
                self._net_grad(q)
            for group in opt.param_groups:
                group["lr"] = loop.net_lr(self.cfg, n, epoch * n + i)
            opt.step()

    return net_steps


def test_net_steps_cut_short_after_the_first_epoch_are_not_correct(monkeypatch):
    from nvfpcc_tpu_torch.train import loop

    monkeypatch.setattr(loop.EpochProgram, "net_steps", _net_steps(lambda i, n: i < 3, lambda i: i))
    line = run_small("train.flagship_vox10", n_blocks=80)
    assert not line["correct"] and line["checks"]["epoch_steps"]["value"] == 2.0
    for k in ("loss_gap", "grad_gap", "change_gap"):  # the first epoch's steps are sound
        assert line["checks"][k]["value"] <= line["checks"][k]["limit"]


def test_half_the_batches_dropped_after_the_first_epoch_are_not_correct(monkeypatch):
    from nvfpcc_tpu_torch.train import loop

    monkeypatch.setattr(loop.EpochProgram, "net_steps", _net_steps(lambda i, n: i % 2 == 0, lambda i: i))
    assert not run_small("train.ctx_vox11", n_blocks=80)["correct"]


def test_a_stale_gradient_after_the_first_epoch_is_not_correct(monkeypatch):
    from nvfpcc_tpu_torch.train import loop

    monkeypatch.setattr(loop.EpochProgram, "net_steps", _net_steps(lambda i, n: True, lambda i: i - i % 2))
    line = run_small("train.flagship_vox10", n_blocks=80)
    c = line["checks"]
    assert not line["correct"] and c["epoch_steps"]["value"] == 0.0
    assert any(c[k]["value"] > c[k]["limit"] for k in ("epoch_loss_gap", "epoch_grad_gap")), c


def test_a_moved_point_is_not_correct(monkeypatch):
    from nvfpcc_tpu_torch.codec import codec

    recon = codec.reconstruct_points

    def moved(decoder, latents, origins, thh):
        pts = recon(decoder, latents, origins, thh)
        pts[0, 2] += 1 if pts[0, 2] % 32 < 31 else -1
        return pts

    monkeypatch.setattr(codec, "reconstruct_points", moved)
    line = run_small("decode.flagship_vox10")
    assert not line["correct"] and line["failed"] == line["attempted"]


def test_half_the_blocks_left_out_is_not_correct(monkeypatch):
    from nvfpcc_tpu_torch.codec import codec

    recon = codec.reconstruct_points

    def half(decoder, latents, origins, thh):
        n = len(origins) // 2
        return recon(decoder, latents[:n], origins[:n], thh)

    monkeypatch.setattr(codec, "reconstruct_points", half)
    assert not run_small("decode.flagship_vox10")["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["train.flagship_vox10", "decode.flagship_vox10", "train.ctx_vox11"])
def test_a_short_run_on_the_card_is_correct(card, name):
    reg = Registry()
    rc, line = execute(reg, reg.cell(name), 2**31 + 99, 3.0, False, card)
    assert rc == 0 and line["correct"], line["checks"]
    assert np.isfinite(line["metrics"]["setup_s"]["value"])
