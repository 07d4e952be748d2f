"""Block-DP training in the port (``nvfpcc_tpu_torch.parallel``,
``train(mesh=...)``) on the CPU over gloo groups, on the JAX suite's toy
(tests/test_parallel.py: 11 blocks, ch=2, chanstr 4,8,4,4, batch 4, 2
epochs, phase_change 1, f32), within that suite's bound (rtol 2e-4, atol
2e-6):

- the pad helpers equal the JAX package's;
- every run replays the JAX package's noise (recorded once in this
  process), so the port's 2- and 3-rank runs are held against the JAX
  package's own block-DP ``train(mesh=...)`` on its 8 virtual CPU devices,
  params, embeddings and metrics; and against the port's one process;
- world size 1 equals no mesh bit for bit, and a 2-rank snapshot resumes
  to the uninterrupted run.

The 2- and 3-rank groups are started once for the module
(``parallel.run_group``: rank 0 in this process, the others spawned, torch
on one thread in each) and run their jobs in turn."""

import json
import os

import numpy as np
import pytest
import torch

from nvfpcc_tpu.config import ModelConfig as JaxModelConfig
from nvfpcc_tpu.config import TrainConfig as JaxTrainConfig
from nvfpcc_tpu.parallel import mesh as jpm
from nvfpcc_tpu.train import loop as JT
from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.models.decoder import TRANSMITTED_KERNELS
from nvfpcc_tpu_torch.ops.gdn import GAMMA_BOUND, GDN
from nvfpcc_tpu_torch.parallel import mesh as pm
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import checkpoint as C
from nvfpcc_tpu_torch.utils.params import flatten_tree, params_to_numpy
from torch_recorded_noise import RecordedNoise
from torch_train_helpers import one_torch_thread, record_jax_noise  # noqa: F401  (autouse fixture)

RTOL, ATOL = 2e-4, 2e-6
MCFG = ModelConfig(ch=2, chanstr="4,8,4,4")
N_BLOCKS = 11  # not a multiple of 2, 3 or 8
EPOCHS = 2
HELD_METRICS = ("pacc", "nacc", "bpp", "lat_amax", "loss")


def _cfg(shuffle="stride", epochs=EPOCHS, batch=4):
    return TrainConfig(epochs=epochs, phase_change=1, batch_size=batch, eval_every=1, compute_dtype="f32",
                       shuffle=shuffle)


def _toy():
    rng = np.random.default_rng(0)
    gt = (rng.uniform(0, 1, (N_BLOCKS, 32, 32, 32)) < 0.02).astype(np.uint8)
    dist = rng.uniform(0, 5, (N_BLOCKS, 32, 32, 32)).astype(np.float32) * (1 - gt)
    return gt, dist


def _noise(batch):
    return RecordedNoise(record_jax_noise(0, N_BLOCKS, batch, EPOCHS, 1))


def _job(gt, dist, d, shuffle="stride", epochs=EPOCHS, resume=False, batch=4):
    return dict(gt=gt, dist=dist, model_cfg=MCFG, cfg=_cfg(shuffle, epochs, batch), checkpoint_dir=str(d),
                metrics_path=str(d / "m.jsonl"), resume=resume, noise=_noise(batch))


def _single(gt, dist, d, shuffle, batch=4):
    lines = []
    _, state = TT.train(gt, dist, MCFG, _cfg(shuffle, batch=batch), "cpu", log=lines.append,
                        checkpoint_dir=str(d), metrics_path=str(d / "m.jsonl"), noise=_noise(batch))
    return {"log": lines, "params": params_to_numpy(state.net), "emb": state.emb.detach().numpy()}


def _jax_mesh(gt, dist, d, shuffle):
    """The JAX package's block-DP run of the same toy and config, over the
    suite's 8 virtual CPU devices (11 blocks padded to 16)."""
    _, state = JT.train(
        gt, dist, JaxModelConfig(ch=MCFG.ch, chanstr=MCFG.chanstr),
        JaxTrainConfig(epochs=EPOCHS, phase_change=1, batch_size=4, eval_every=100, compute_dtype="f32",
                       shuffle=shuffle),
        log=lambda s: None, mesh=jpm.make_mesh(), metrics_path=str(d / "m.jsonl"))
    return {"params": {k: np.asarray(v) for k, v in flatten_tree(state.params).items()},
            "emb": np.asarray(state.emb)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    gt, dist = _toy()
    d = {k: tmp_path_factory.mktemp(k) for k in (
        "one", "one_none", "one_b16", "w1", "w2", "w2_resumed", "w2_b16", "w3", "jax_w8", "jax_w8_none")}
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the spawned ranks read it at start
    try:
        out = {"one": _single(gt, dist, d["one"], "stride"), "one_none": _single(gt, dist, d["one_none"], "none"),
               "one_b16": _single(gt, dist, d["one_b16"], "stride", batch=16)}
        out["w1"] = pm.run_group(TT.train_on_mesh, 1, "gloo", ["cpu"], args=([_job(gt, dist, d["w1"])],))
        out["w2"] = pm.run_group(
            TT.train_on_mesh, 2, "gloo", ["cpu"] * 2, timeout_s=300,
            args=([_job(gt, dist, d["w2"]), _job(gt, dist, d["w2_resumed"], epochs=1),
                   _job(gt, dist, d["w2_resumed"], resume=True), _job(gt, dist, d["w2_b16"], batch=16)],))
        out["w3"] = pm.run_group(TT.train_on_mesh, 3, "gloo", ["cpu"] * 3, timeout_s=300,
                                 args=([_job(gt, dist, d["w3"], shuffle="none")],))
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    out["jax_w8"] = _jax_mesh(gt, dist, d["jax_w8"], "stride")
    out["jax_w8_none"] = _jax_mesh(gt, dist, d["jax_w8_none"], "none")
    out["dirs"], out["toy"] = d, (gt, dist)
    return out


def _metrics(d):
    with open(d / "m.jsonl") as f:
        return [json.loads(line) for line in f]


def _assert_follows(got, want, got_dir, want_dir):
    """Block-DP ``got`` against one process ``want``: the transmitted
    kernels, the embeddings and the reduced per-epoch metrics."""
    gp, wp = flatten_tree(got["params"]), flatten_tree(want["params"])
    for name in TRANSMITTED_KERNELS:
        k = f"decoder/{name}/kernel"
        np.testing.assert_allclose(gp[k], wp[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert got["emb"].shape == want["emb"].shape == (N_BLOCKS, 2, 2, 2, 2)
    np.testing.assert_allclose(got["emb"], want["emb"], rtol=RTOL, atol=ATOL)
    gm, wm = _metrics(got_dir), _metrics(want_dir)
    assert [(r["epoch"], r["q"]) for r in gm] == [(r["epoch"], r["q"]) for r in wm] == [(0, 1), (1, 2)]
    for g, w in zip(gm, wm):
        for key in HELD_METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL, err_msg=key)


def _assert_replicated(ranks):
    """Every rank ends with rank 0's params and embeddings, bit for bit."""
    p0 = flatten_tree(ranks[0]["params"])
    for r in ranks[1:]:
        for k, v in flatten_tree(r["params"]).items():
            np.testing.assert_array_equal(v, p0[k], err_msg=k)
        np.testing.assert_array_equal(r["emb"], ranks[0]["emb"])


def test_pad_helpers_equal_the_jax_package():
    mesh = jpm.make_mesh()  # the suite's 8 virtual CPU devices
    assert mesh.devices.size == 8
    for n in (1, 8, 11, 16, 1314):
        assert pm.padded_block_count(n, 8) == jpm.padded_block_count(n, mesh)
    assert pm.padded_block_count(11, 8) == 16 and pm.padded_block_count(11, 3) == 12
    x = np.arange(11 * 24, dtype=np.float32).reshape(11, 2, 2, 2, 3)
    for n_padded in (11, 12, 16):
        got, want = pm.pad_blocks(x, n_padded), jpm.pad_blocks(x, n_padded)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_rows_split_the_padded_axis():
    rows = [pm.Mesh(r, 3, torch.device("cpu"), "gloo").rows(12) for r in range(3)]
    assert rows == [slice(0, 4), slice(4, 8), slice(8, 12)]
    with pytest.raises(ValueError, match="not divisible"):
        pm.Mesh(0, 3, torch.device("cpu"), "gloo").rows(11)


def test_gdn_gates_the_sum_of_the_ranks_gradients():
    """An entry of IGDN's gamma below its bound, where the bound passes only
    a negative gradient; two ranks' rows whose shares have opposite signs
    and a negative sum. One process gates the sum, so the entry moves; a
    rank that gated its own share would pass only the negative one. With
    ``defer_gate`` each rank passes its whole share, and ``gate_grads``
    gates the sum: one process's gradient."""
    m = GDN(2, inverse=True)
    with torch.no_grad():
        m.gamma[0, 1] = GAMMA_BOUND / 2
    x = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 1.5, (2, 5, 2)), dtype=torch.float32)
    sign = torch.tensor([1.0, -3.0])[:, None]

    def grads(*ranks):
        """One forward and backward per rank, accumulated in ``.grad``; a
        rank's loss weighs its rows' output by their signs (one process is
        one rank holding all rows)."""
        m.beta.grad = m.gamma.grad = None
        for rows in ranks:
            (sign[rows] * m(x[rows])[..., 0]).sum().backward()
        return m.gamma.grad.clone()

    whole, each = grads([0, 1]), grads([0], [1])
    m.defer_gate = True
    grads([0], [1])
    m.gate_grads()
    assert whole[0, 1] < 0 and each[0, 1] < whole[0, 1]
    torch.testing.assert_close(m.gamma.grad, whole, rtol=1e-6, atol=0)


@pytest.mark.parametrize("job,one,d", [(0, "one", "w2"), (3, "one_b16", "w2_b16")], ids=["batch4", "one_batch"])
def test_two_ranks_follow_one_process(runs, job, one, d):
    """Batches of 4 (3 a step), and one batch of 16 an epoch (a rank's
    metric rows are then one row, whose lat_amax takes the max)."""
    ranks = [r[job] for r in runs["w2"]]
    _assert_replicated(ranks)
    _assert_follows(ranks[0], runs[one], runs["dirs"][d], runs["dirs"][one])


@pytest.mark.parametrize("port,jax_run", [("w2", "jax_w8"), ("w3", "jax_w8_none")], ids=["2_ranks", "3_ranks"])
def test_block_dp_follows_the_jax_package_block_dp(runs, port, jax_run):
    """The port's 2-rank (stride) and 3-rank (shuffle none) runs against the
    JAX package's ``train(mesh=...)`` on the same toy, config and noise:
    every param, the embeddings (real blocks only in both) and each epoch's
    pacc, nacc, bpp, lat_amax and loss. Every param: GDN's ``gamma`` sits
    on its lower bound in places, where the bound passes a gradient by its
    sign, so it holds that the gate acts on the group's sum of gradients
    and not on each rank's share."""
    got, want = runs[port][0][0], runs[jax_run]
    gp = flatten_tree(got["params"])
    assert set(gp) == set(want["params"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(gp[k], v, rtol=RTOL, atol=ATOL, err_msg=k)
    assert got["emb"].shape == want["emb"].shape == (N_BLOCKS, 2, 2, 2, 2)
    np.testing.assert_allclose(got["emb"], want["emb"], rtol=RTOL, atol=ATOL)
    gm, wm = _metrics(runs["dirs"][port]), _metrics(runs["dirs"][jax_run])
    assert [(r["epoch"], r["q"]) for r in gm] == [(r["epoch"], r["q"]) for r in wm] == [(0, 1), (1, 2)]
    for g, w in zip(gm, wm):
        assert list(g) == list(w)  # the same keys in the same order
        for key in HELD_METRICS:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL, err_msg=key)


def test_three_ranks_with_batches_wholly_on_one_rank(runs):
    """shuffle none: the 12 padded rows split 4/4/4, so each batch of 4 lies
    on one rank and the other two step on zero gradients."""
    idx, mask = TT.batch_plan(N_BLOCKS, 4, "none", 0, 0)
    owners = [{int(i) // 4 for i, m in zip(b, bm) if m} for b, bm in zip(idx, mask)]
    assert owners == [{0}, {1}, {2}]
    ranks = [r[0] for r in runs["w3"]]
    _assert_replicated(ranks)
    _assert_follows(ranks[0], runs["one_none"], runs["dirs"]["w3"], runs["dirs"]["one_none"])


def test_world_size_one_equals_no_mesh_bit_for_bit(runs):
    got, want = runs["w1"][0][0], runs["one"]
    gp, wp = flatten_tree(got["params"]), flatten_tree(want["params"])
    assert set(gp) == set(wp)
    for k in wp:
        np.testing.assert_array_equal(gp[k], wp[k], err_msg=k)
    np.testing.assert_array_equal(got["emb"], want["emb"])
    assert _metrics(runs["dirs"]["w1"]) == _metrics(runs["dirs"]["one"])
    strip = lambda lines: [x.split("s] ")[-1] for x in lines if "block-DP" not in x]  # noqa: E731
    assert strip(got["log"]) == strip(want["log"])


def test_snapshot_resumes_to_the_uninterrupted_run(runs):
    straight, _, resumed = runs["w2"][0][:3]
    assert any("resumed from" in x and "state_0000" in x for x in resumed["log"])
    assert sum(" TRAIN " in x for x in resumed["log"]) == 1
    for k, v in flatten_tree(straight["params"]).items():
        np.testing.assert_array_equal(flatten_tree(resumed["params"])[k], v, err_msg=k)
    np.testing.assert_array_equal(resumed["emb"], straight["emb"])
    a = C.load_train_state(str(runs["dirs"]["w2"] / "state_0001.npz"))
    b = C.load_train_state(str(runs["dirs"]["w2_resumed"] / "state_0001.npz"))
    fa, fb = flatten_tree(a), flatten_tree(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_snapshot_from_another_world_size_raises(runs):
    """The 2-rank snapshot holds 12 padded rows; one rank pads 11 blocks to 11."""
    gt, dist = runs["toy"]
    job = _job(gt, dist, runs["dirs"]["w2"], epochs=3, resume=True)
    with pytest.raises(ValueError, match="mesh size changed"):
        pm.run_group(TT.train_on_mesh, 1, "gloo", ["cpu"], args=([job],))
    with pytest.raises(ValueError, match="mesh size changed"):
        TT.train(gt, dist, MCFG, _cfg(epochs=3), "cpu", checkpoint_dir=str(runs["dirs"]["w2"]), resume=True,
                 log=lambda s: None)


def test_checkpoints_hold_the_real_blocks_and_rank0_logs_once(runs):
    ranks = [r[0] for r in runs["w2"]]
    d = runs["dirs"]["w2"]
    assert sorted(os.listdir(d)) == ["0000.npz", "0001.npz", "m.jsonl", "state_0000.npz", "state_0001.npz"]
    params, emb, meta = C.load_checkpoint_meta(str(d / "0001.npz"))
    assert emb.shape == (N_BLOCKS, 2, 2, 2, 2) and meta["chanstr"] == "4,8,4,4"
    np.testing.assert_array_equal(emb, ranks[0]["emb"])
    for k, v in flatten_tree(params).items():
        np.testing.assert_array_equal(v, flatten_tree(ranks[0]["params"])[k], err_msg=k)
    snap = C.load_train_state(str(d / "state_0001.npz"))
    assert snap["emb"].shape[0] == snap["emb_opt"]["exp_avg"].shape[0] == 12
    assert snap["emb_opt"]["step"] == 2 and not snap["emb_opt"]["exp_avg"][N_BLOCKS:].any()
    assert sum(" TRAIN " in x for x in ranks[0]["log"]) == 2 and ranks[1]["log"] == []
    assert sum("TEST]" in x for x in ranks[0]["log"]) == 2 and len(_metrics(d)) == 2
    assert any("2 ranks (gloo, cpu)" in x and "6 gradient all-reduces" in x for x in ranks[0]["log"])
