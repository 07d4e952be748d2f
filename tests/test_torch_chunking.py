"""The port's counterpart of tests/test_train_chunking.py: ``train`` runs
chunks of epochs between host-visible boundaries, as the JAX package's
``train`` dispatches one program per chunk, and a chunk is a cadence, not a
numerics change. On the CPU (7 blocks of 32^3, ch=2, chanstr 4,8,4,4,
batch 4, f32, the ``stride`` and ``random`` shuffles), the chunked ``train``
equals a loop of per-epoch ``run_epoch`` calls with a fetch after each
epoch bit for bit: the state, every metrics line and every checkpoint.
``chunk_end`` gives the JAX ``train``'s chunk boundaries
(``nvfpcc_tpu/train/loop.py:565-577``) on a table of cases, and CUDA graphs
asked for on the CPU raise."""

import json
import os

import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.train import ctx_fit as TF
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import checkpoint as TCK
from nvfpcc_tpu_torch.utils import params as TP

N_BLOCKS = 7
MCFG = ModelConfig(ch=H.CH, chanstr=H.CHANSTR)
# chunks [0] (the phase changes at 1) and [1, 2, 3]; checkpoints at 0 and 3
KW = dict(batch_size=4, epochs=4, phase_change=1, eval_every=3, seed=3, compute_dtype="f32")


def _per_epoch_loop(gt, dist, cfg, ckdir):
    """The eager per-epoch path: one run_epoch and one fetch an epoch, the
    metrics lines and checkpoints train writes."""
    spec = H.TM.build_model_spec(H.CH, H.CHANNELS)
    net = TT.initial_params(spec, MCFG)
    emb = H.TM.init_embeddings(N_BLOCKS, H.CH).requires_grad_(True)
    opt, emb_opt = TT.make_optimizers(cfg, net, emb)
    state = TT.TrainState(net, opt, emb, emb_opt)
    gt_d, dist_d = TT._prep_dense(gt, dist, "cpu")
    valid, n_pts = torch.ones(N_BLOCKS), float(gt.sum())
    noise = TT.NoiseSource(cfg.seed, spec, "cpu")
    lines = []
    for epoch in range(cfg.epochs):
        q = 1 if epoch < cfg.phase_change else 2
        idx, mask = TT.batch_plan(N_BLOCKS, cfg.batch_size, cfg.shuffle, cfg.seed, epoch)
        rows = TT.run_epoch(state, cfg, gt_d, dist_d, torch.as_tensor(idx).long(), torch.as_tensor(mask), valid,
                            n_pts, q, noise, epoch).cpu().numpy()
        s = TT.summarize_metrics({k: rows[:, j] for j, k in enumerate(TT.METRIC_KEYS)})
        lines.append(json.dumps({"epoch": epoch, "q": q, **s}))
        if epoch % cfg.eval_every == 0:
            TT.evaluate(net, cfg, state.emb, gt_d, dist_d, valid, n_pts)
            TT._save_epoch(ckdir, epoch, state, MCFG, N_BLOCKS, None)
    return state, lines


@pytest.mark.parametrize("shuffle", ["stride", "random"])
def test_chunked_train_equals_the_per_epoch_loop(shuffle, tmp_path):
    gt, dist = H.toy_grids(N_BLOCKS, seed=0)
    cfg = TrainConfig(**KW, shuffle=shuffle)
    log = []
    _, got = TT.train(gt, dist, MCFG, cfg, "cpu", checkpoint_dir=str(tmp_path / "chunked"), log=log.append,
                      metrics_path=str(tmp_path / "chunked.jsonl"))
    want, want_lines = _per_epoch_loop(gt, dist, cfg, str(tmp_path / "loop"))

    a, b = H.port_state_numpy(got), H.port_state_numpy(want)
    assert a["count"] == b["count"] == 8 and a["emb_count"] == b["emb_count"] == 4 and got.epoch == 3
    for k, v in TP.flatten_tree(b["params"]).items():
        np.testing.assert_array_equal(TP.flatten_tree(a["params"])[k], v, err_msg=k)
        np.testing.assert_array_equal(a["mu"][k], b["mu"][k], err_msg=k)
        np.testing.assert_array_equal(a["nu"][k], b["nu"][k], err_msg=k)
    for k in ("emb", "emb_mu", "emb_nu"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    with open(tmp_path / "chunked.jsonl") as f:
        assert f.read().splitlines() == want_lines
    names = ["0000.npz", "0003.npz", "state_0000.npz", "state_0003.npz"]
    assert sorted(os.listdir(tmp_path / "chunked")) == sorted(os.listdir(tmp_path / "loop")) == names
    for name in names:
        with np.load(tmp_path / "chunked" / name) as x, np.load(tmp_path / "loop" / name) as y:
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name} {k}")

    # one TRAIN line an epoch, in order; a chunk's lines carry its seconds over its epochs
    train_lines = [line for line in log if " TRAIN " in line]
    assert [int(line.split()[1]) for line in train_lines] == list(range(4))
    secs = [line.split(" TRAIN ")[1].split("]")[0] for line in train_lines]
    assert secs[1] == secs[2] == secs[3]
    assert [int(line.split()[1]) for line in log if "TEST]" in line] == [0, 3]


# (epochs, phase_change, eval_every, e0, profile pending) -> last epoch of the chunk,
# each case worked out from nvfpcc_tpu/train/loop.py:565-577
CHUNK_CASES = [
    # eval_every 0: only the phase change and the run's end cut
    ((10, 4, 0, 0, False), 3), ((10, 4, 0, 2, False), 3), ((10, 4, 0, 4, False), 9), ((10, 4, 0, 9, False), 9),
    # eval_every 1: every epoch is a boundary
    ((10, 4, 1, 0, False), 0), ((10, 4, 1, 5, False), 5),
    # eval_every 10, the reference recipe (501 epochs, q=2 from 300): 0, then up to each multiple of 10
    ((501, 300, 10, 0, False), 0), ((501, 300, 10, 1, False), 10), ((501, 300, 10, 11, False), 20),
    ((501, 300, 10, 300, False), 300), ((501, 300, 10, 491, False), 500), ((501, 300, 10, 500, False), 500),
    # the phase change inside a chunk cuts it, at its edge it is the boundary
    ((501, 295, 10, 291, False), 294), ((501, 295, 10, 295, False), 300), ((501, 11, 10, 1, False), 10),
    ((501, 12, 10, 1, False), 10), ((501, 12, 10, 11, False), 11),
    # a resumed start (after the snapshot of epoch 20) and the run's end inside a chunk
    ((501, 300, 10, 21, False), 30), ((15, 300, 10, 11, False), 14), ((15, 3, 10, 11, False), 14),
    # a pending profile window keeps epochs up to 6 single, then the cadence resumes
    ((501, 300, 10, 1, True), 1), ((501, 300, 10, 3, True), 3), ((501, 300, 10, 6, True), 6),
    ((501, 300, 10, 7, True), 10), ((501, 2, 0, 5, True), 5), ((501, 2, 0, 7, True), 500),
]


@pytest.mark.parametrize("case,e1", CHUNK_CASES)
def test_chunk_end_gives_the_jax_boundaries(case, e1):
    epochs, phase_change, eval_every, e0, pending = case
    cfg = TrainConfig(epochs=epochs, phase_change=phase_change, eval_every=eval_every)
    assert TT.chunk_end(cfg, e0, pending) == e1


def test_graphs_on_the_cpu_raise():
    gt, dist = H.toy_grids(N_BLOCKS, seed=0)
    cfg = TrainConfig(**{**KW, "epochs": 1}, shuffle="stride")
    with pytest.raises(ValueError, match="graphs=True"):
        TT.train(gt, dist, MCFG, cfg, "cpu", log=lambda s: None, graphs=True)
    spec = H.TM.build_model_spec(H.CH, H.CHANNELS, entropy_mode="ctx")
    with pytest.raises(ValueError, match="CUDA graphs of the fit"):
        TF.fit_ctx_predictor(spec, np.zeros((2, 2, 2, 2, H.CH), np.int64), "cpu", graphs=True)
