"""The trainer's CUDA-graph bookkeeping on the CPU: ``EpochProgram`` with
its graphs emulated equals the eager ``EpochProgram`` bit for bit.

A CUDA graph needs a card, so ``loop.capture`` is replaced here by a
stand-in that does what ``train/graphs.capture`` does before it captures
(``graphs.warm_up``: the step run ``WARMUP_RUNS`` times, then the tensors
in ``mutated`` and the registered generators put back) and returns an
object whose ``replay()`` runs the step. The package keeps no CPU graph
path: ``train(graphs=True)`` on the CPU raises
(``tests/test_torch_chunking.py``). Held, on the toy grids at batch 2, one
torch thread, for every entropy mode in bf16 and for ``channel`` in f32,
over 2 epochs across the phase change (each phase captures at its first
epoch): every parameter, the embeddings, both Adams' moments and steps and
every metric row. A one-batch epoch runs the warm-up past the epoch's one
row, the case of the row counter's wrap (``EpochProgram._net_grad``).

What this cannot see: a real replay reads fixed storage and runs none of
the step's host code, so a host value baked into a capture (a Python
number that changes between steps, a tensor made anew at each call), a
kernel the capture records differently from an eager launch, or an
allocation the graph's pool reuses shows only on the card
(``chip_smoke.py:phase_graphs``)."""

import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.models import decoder as M
from nvfpcc_tpu_torch.train import graphs as G
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import params as TP


class _Replayed:
    """A captured graph's stand-in: each replay runs the step eagerly."""

    def __init__(self, step):
        self.step = step

    def replay(self):
        self.step()

    def pool(self):
        return None


def _emulated_capture(step, mutated, generators=(), pool=None, stream=None):
    G.warm_up(step, mutated, generators)
    return _Replayed(step)


def _run(mode, dtype, n_blocks, epochs, graphs):
    """``epochs`` epochs (q=1 then q=2) of one ``EpochProgram`` on the toy
    grids; the state and every epoch's metric rows as numpy."""
    gt, dist = H.toy_grids(n_blocks, seed=1)
    mcfg = ModelConfig(ch=H.CH, chanstr=H.CHANSTR, entropy_mode=mode)
    cfg = TrainConfig(batch_size=2, epochs=epochs, phase_change=1, seed=5, compute_dtype=dtype)
    spec = M.build_model_spec(H.CH, H.CHANNELS, entropy_mode=mode, ctx_hidden=mcfg.ctx_hidden)
    net = TT.initial_params(spec, mcfg)
    emb = M.init_embeddings(n_blocks, H.CH).requires_grad_(True)
    opt, emb_opt = TT.make_optimizers(cfg, net, emb)
    state = TT.TrainState(net, opt, emb, emb_opt)
    gt_d, dist_d = TT._prep_dense(gt, dist, "cpu")
    noise = TT.NoiseSource(cfg.seed, spec, "cpu")
    program = TT.EpochProgram(state, cfg, gt_d, dist_d, torch.ones(n_blocks), float(gt.sum()), noise)
    program.use_graphs = graphs
    rows = []
    for epoch in range(epochs):
        idx, mask = TT.batch_plan(n_blocks, cfg.batch_size, cfg.shuffle, cfg.seed, epoch)
        q = 1 if epoch < cfg.phase_change else 2
        rows.append(program.run(epoch, q, torch.from_numpy(idx).long(), torch.from_numpy(mask)).numpy())
    # a phase's graphs are dropped when the next begins
    assert list(program.graphs) == ([2] if graphs else [])
    s = H.port_state_numpy(state)
    out = {f"params/{k}": v for k, v in TP.flatten_tree(s.pop("params")).items()}
    for k in ("mu", "nu"):
        out.update({f"{k}/{n}": v for n, v in s.pop(k).items()})
    out.update({k: np.asarray(v) for k, v in s.items()})
    out["rows"] = np.stack(rows)
    return out


def _assert_bits_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


# every entropy mode in bf16 (the trainer's default compute), channel in f32
CASES = [(m, "bf16") for m in M.ENTROPY_MODES] + [("channel", "f32")]


@pytest.mark.parametrize("mode,dtype", CASES)
def test_emulated_graphs_equal_eager(mode, dtype, monkeypatch):
    monkeypatch.setattr(TT, "capture", _emulated_capture)
    # 5 blocks at batch 2: 3 net steps an epoch, the last padded (more
    # steps than warm-up runs, so a row counter left unrestored shows)
    got = _run(mode, dtype, 5, 2, graphs=True)
    want = _run(mode, dtype, 5, 2, graphs=False)
    assert got["count"] == want["count"] == 6 and got["emb_count"] == 2
    _assert_bits_equal(got, want)


def test_one_batch_epoch_under_emulated_graphs(monkeypatch):
    """One net step an epoch: the capture's two warm-up runs step the row
    counter past the epoch's last row, which it must wrap."""
    monkeypatch.setattr(TT, "capture", _emulated_capture)
    got = _run("channel", "bf16", 2, 2, graphs=True)
    want = _run("channel", "bf16", 2, 2, graphs=False)
    assert got["count"] == 2 and got["rows"].shape == (2, 1, len(TT.METRIC_KEYS))
    _assert_bits_equal(got, want)


def test_warm_up_puts_back_what_the_step_changes():
    """``warm_up`` runs the step ``WARMUP_RUNS`` times and restores the
    listed tensors and generators; what is not listed keeps the runs'
    effect."""
    t, out = torch.zeros(3), torch.zeros(3)
    gen = torch.Generator().manual_seed(7)
    calls = []

    def step():
        calls.append(1)
        t.add_(1)
        out.copy_(torch.rand(3, generator=gen))

    first = torch.rand(3, generator=torch.Generator().manual_seed(7))
    G.warm_up(step, [t], [gen])
    assert len(calls) == G.WARMUP_RUNS and torch.equal(t, torch.zeros(3))
    assert not torch.equal(out, first)  # the second draw
    assert torch.equal(torch.rand(3, generator=gen), first)
