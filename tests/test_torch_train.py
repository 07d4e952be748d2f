"""nvfpcc_tpu_torch.train.loop against nvfpcc_tpu.train.loop on the CPU, at
the JAX suite's test size (ch=2, chanstr 4,8,4,4, 6 blocks of 32^3, batch 4,
so the last batch is padded), f32 unless said, with the JAX package's noise
replayed: one whole epoch per quantization phase, three epochs across the
phase change through both ``train()``s, checkpoints crossing both ways,
straight == resumed, snapshots, the metrics file, the divergence guards.

Tolerances (f32, measured over one epoch from the same start: params differ
by at most 4.5e-7 where they move by 2e-3; Adam moments by 3.4e-5 / 1.8e-4 of
their largest magnitude): params and embeddings atol 5e-6, first moments
1e-3 and second moments 2e-3 of the leaf's largest magnitude, summarized
metrics rtol 1e-5. After three epochs from the cold start (Adam's first
steps are close to lr * sign(g), which amplifies rounding where g is tiny):
params and embeddings atol 2e-5 (measured 6.4e-6 on embeddings that moved by
1.5e-2).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import assert_state_close as _assert_close
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from nvfpcc_tpu import codec as JC
from nvfpcc_tpu.config import CodecConfig as JaxCodecConfig
from nvfpcc_tpu.config import ModelConfig as JaxModelConfig
from nvfpcc_tpu.config import TrainConfig as JaxTrainConfig
from nvfpcc_tpu.octree.partition import leaf_origins
from nvfpcc_tpu.train import loop as JT
from nvfpcc_tpu.utils import checkpoint as JCK
from nvfpcc_tpu_torch import codec as TC
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig, TrainConfig
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import checkpoint as TCK
from nvfpcc_tpu_torch.utils import params as TP

N = 6
EPOCH = 3  # the epoch number whose noise keys and batch plan the one-epoch tests use


def _assert_metrics_close(got: dict, want: dict, rtol=1e-5):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


@pytest.fixture(scope="module")
def toy():
    gt, dist = H.toy_grids(N)
    _, tree, emb = H.trained_like(N)
    return {"gt": gt, "dist": dist, "npts": float(gt.sum()), "tree": tree, "emb": emb}


def _fresh_state(cfg) -> TT.TrainState:
    spec = H.TM.build_model_spec(H.CH, H.CHANNELS)
    net = TT.initial_params(spec, ModelConfig(ch=H.CH, chanstr=H.CHANSTR))
    emb = H.TM.init_embeddings(N, H.CH).requires_grad_(True)
    opt, emb_opt = TT.make_optimizers(cfg, net, emb)
    return TT.TrainState(net, opt, emb, emb_opt)


class _OneEpochReplay(H.JaxReplayNoise):
    """make_epoch_fn takes its key directly: always the keys of ``EPOCH``."""

    def start_epoch(self, epoch, n_batches):
        super().start_epoch(EPOCH, n_batches)


@pytest.mark.parametrize("q", [1, 2])
def test_one_epoch_matches_make_epoch_fn(toy, q):
    """From the same trained-like start: params, both Adam states, embeddings
    and the summarized metrics after one whole epoch."""
    jcfg = JaxTrainConfig(batch_size=4, compute_dtype="f32")
    tcfg = TrainConfig(batch_size=4, compute_dtype="f32")
    spec, params, opt_state, emb, emb_opt_state, net_opt, emb_opt = H.jax_fresh_state(
        jcfg, N, toy["tree"], toy["emb"])
    start = H.jax_state_numpy(params, opt_state, emb, emb_opt_state)
    idx, mask = JT.batch_plan(N, 4, "stride", 0, EPOCH)
    assert mask[-1].tolist() == [1, 1, 0, 0]
    gt_d, dist_d = JT._prep_dense(toy["gt"], toy["dist"])
    key = jax.random.fold_in(jax.random.PRNGKey(0), EPOCH)
    p1, o1, e1, eo1, jm = JT.make_epoch_fn(spec, jcfg, net_opt, emb_opt, toy["npts"], q)(
        params, opt_state, jnp.copy(emb), emb_opt_state, gt_d, dist_d, jnp.asarray(idx),
        jnp.asarray(mask), jnp.ones((N,), jnp.float32), key, JT.rd_weights(jcfg))
    want = H.jax_state_numpy(p1, o1, e1, eo1)

    state = H.port_state_from_numpy(tcfg, start)
    tg, td = TT._prep_dense(toy["gt"], toy["dist"], "cpu")
    stacked = TT.run_epoch(
        state, tcfg, tg, td, torch.as_tensor(idx).long(), torch.as_tensor(mask), torch.ones(N),
        toy["npts"], q, _OneEpochReplay(0), 0)
    assert tuple(stacked.shape) == (2, len(TT.METRIC_KEYS))
    _assert_close(H.port_state_numpy(state), want)
    assert np.abs(want["emb"] - start["emb"]).max() > 1e-3  # the state did move
    _assert_metrics_close(
        TT.summarize_metrics({k: stacked[:, j].numpy() for j, k in enumerate(TT.METRIC_KEYS)}),
        JT.summarize_metrics(jax.device_get(jm)))


def test_bf16_epoch_trains_and_keeps_f32_state(toy):
    """Mixed precision leaves params, Adam moments and embeddings f32 (the
    JAX suite's tests/test_mixed_precision.py is the model)."""
    tcfg = TrainConfig(batch_size=4, compute_dtype="bf16")
    state = _fresh_state(tcfg)
    net, spec = state.net, state.net.spec
    before = TP.flatten_tree(TP.params_to_numpy(net))
    idx, mask = TT.batch_plan(N, 4, "stride", 0, 0)
    tg, td = TT._prep_dense(toy["gt"], toy["dist"], "cpu")
    stacked = TT.run_epoch(state, tcfg, tg, td, torch.as_tensor(idx).long(), torch.as_tensor(mask),
                           torch.ones(N), toy["npts"], 2, TT.NoiseSource(0, spec, "cpu"), 0)
    assert torch.isfinite(stacked).all()
    after = TP.flatten_tree(TP.params_to_numpy(net))
    assert any(np.abs(after[k] - before[k]).max() > 0 for k in after)
    assert all(p.dtype == torch.float32 for p in net.parameters()) and state.emb.dtype == torch.float32
    for opt in (state.opt, state.emb_opt):
        for st in opt.state.values():
            assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    assert not torch.equal(state.emb.detach(), torch.ones_like(state.emb))


# ------------------------------------------------ train() in both packages


KW = dict(batch_size=4, epochs=3, phase_change=2, eval_every=2, compute_dtype="f32", seed=7)


@pytest.fixture(scope="module")
def both_runs(toy, tmp_path_factory):
    """Three epochs across the phase change (q=1, q=1, q=2), eval and
    checkpoint at epochs 0 and 2, through both packages' ``train()``."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    jlog, tlog = [], []
    jdir, tdir = str(root / "jax_ck"), str(root / "port_ck")
    _, jstate = JT.train(
        toy["gt"], toy["dist"], JaxModelConfig(ch=H.CH, chanstr=H.CHANSTR), JaxTrainConfig(**KW),
        checkpoint_dir=jdir, log=jlog.append, metrics_path=str(root / "jax.jsonl"))
    _, tstate = TT.train(
        toy["gt"], toy["dist"], ModelConfig(ch=H.CH, chanstr=H.CHANSTR), TrainConfig(**KW), "cpu",
        checkpoint_dir=tdir, log=tlog.append, metrics_path=str(root / "port.jsonl"),
        noise=H.JaxReplayNoise(KW["seed"]))
    out.update(root=root, jdir=jdir, tdir=tdir, jstate=jstate, tstate=tstate, jlog=jlog, tlog=tlog)
    return out


def test_train_three_epochs_across_the_phase_change(both_runs):
    r = both_runs
    want = H.jax_state_numpy(r["jstate"].params, r["jstate"].opt_state, r["jstate"].emb,
                             r["jstate"].emb_opt_state)
    got = H.port_state_numpy(r["tstate"])
    assert got["count"] == 6 and got["emb_count"] == 3 and r["tstate"].epoch == 2
    _assert_close(got, want, atol=2e-5)


def test_metrics_file_and_log_lines(both_runs):
    r = both_runs
    jrows = [json.loads(line) for line in open(r["root"] / "jax.jsonl")]
    trows = [json.loads(line) for line in open(r["root"] / "port.jsonl")]
    assert [(x["epoch"], x["q"]) for x in trows] == [(0, 1), (1, 1), (2, 2)]
    for j, t in zip(jrows, trows):
        assert list(t) == list(j)  # same keys in the same order
        _assert_metrics_close(t, j)
    # 3 TRAIN lines and 2 TEST lines each, the same numbers printed
    for tag, n in (("TRAIN", 3), ("TEST]", 2)):
        jl, tl = ([x for x in log if tag in x] for log in (r["jlog"], r["tlog"]))
        assert len(jl) == len(tl) == n
    j_eval = [float(x.split("bpp: ")[1].split()[0]) for x in r["jlog"] if "TEST]" in x]
    t_eval = [float(x.split("bpp: ")[1].split()[0]) for x in r["tlog"] if "TEST]" in x]
    np.testing.assert_allclose(t_eval, j_eval, rtol=1e-4)


def test_checkpoints_and_snapshots_written(both_runs):
    r = both_runs
    assert sorted(os.listdir(r["tdir"])) == ["0000.npz", "0002.npz", "state_0000.npz", "state_0002.npz"]
    assert TCK.latest_train_state(r["tdir"]).endswith("state_0002.npz")
    tparams, temb, tmeta = TCK.load_checkpoint_meta(TCK.latest_checkpoint(r["tdir"]))
    jparams, jemb, jmeta = JCK.load_checkpoint_meta(JCK.latest_checkpoint(r["jdir"]))
    assert tmeta == jmeta
    np.testing.assert_allclose(temb, jemb, rtol=0, atol=2e-5)
    assert set(TP.flatten_tree(tparams)) == set(TP.flatten_tree(jparams))


def test_checkpoints_cross_packages_both_ways(both_runs):
    """A checkpoint the port trained encodes in the JAX package and decodes
    in the port; one the JAX package trained encodes in the port and decodes
    in the JAX package. Point sets may differ only in the thh band, which a
    3-epoch model puts nothing into at thh 0.3."""
    r = both_runs
    origins = leaf_origins(np.array([[1, 1, 1], [40, 1, 1], [1, 40, 70], [70, 70, 1], [100, 40, 40], [100, 100, 100]]), 7, 2)
    assert len(origins) == N
    jm, tm = JaxModelConfig(ch=H.CH, chanstr=H.CHANSTR), ModelConfig(ch=H.CH, chanstr=H.CHANSTR)
    kw = dict(thh_encode=0.3, thh_decode=0.3, depth=7, level=2)
    tparams, temb = TCK.load_checkpoint(TCK.latest_checkpoint(r["tdir"]))
    jparams, jemb = JCK.load_checkpoint(JCK.latest_checkpoint(r["jdir"]))

    j_res = JC.encode(H.jtree(tparams), temb, origins, jm, JaxCodecConfig(**kw), 1000)
    t_points, _ = TC.decode(j_res.pack, "cpu")
    t_res = TC.encode(jparams, jemb, origins, tm, CodecConfig(**kw), 1000, "cpu")
    j_points, _ = JC.decode(t_res.pack)
    for enc, dec in ((j_res.points, t_points), (t_res.points, j_points)):
        a, b = set(map(tuple, np.asarray(enc))), set(map(tuple, np.asarray(dec)))
        assert len(a) > 0 and len(a ^ b) <= 1e-4 * len(a)
    assert t_res.pack["latent_pack"]["shape"] == j_res.pack["latent_pack"]["shape"]


# ------------------------------------------------- resume, snapshots, guards


def _run(toy, ckdir, epochs, resume=False, **kw):
    cfg = TrainConfig(**{**KW, "epochs": epochs, **kw})
    return TT.train(toy["gt"], toy["dist"], ModelConfig(ch=H.CH, chanstr=H.CHANSTR), cfg, "cpu",
                    checkpoint_dir=ckdir, log=lambda s: None, resume=resume)[1]


def test_straight_run_equals_resumed_run_bitwise(toy, tmp_path):
    """f32 on the CPU with the default noise source (re-seeded per epoch):
    4 epochs straight == 3 epochs, then --resume from the snapshot of epoch 2."""
    straight = H.port_state_numpy(_run(toy, str(tmp_path / "a"), 4))
    _run(toy, str(tmp_path / "b"), 3)
    logs = []
    cfg = TrainConfig(**{**KW, "epochs": 4})
    resumed = TT.train(toy["gt"], toy["dist"], ModelConfig(ch=H.CH, chanstr=H.CHANSTR), cfg, "cpu",
                       checkpoint_dir=str(tmp_path / "b"), log=logs.append, resume=True)[1]
    assert any("resumed from" in x and "state_0002" in x for x in logs)
    assert sum("TRAIN" in x for x in logs) == 1 and resumed.epoch == 3
    got = H.port_state_numpy(resumed)
    assert got["count"] == straight["count"] == 8 and got["emb_count"] == 4
    for k, v in TP.flatten_tree(straight["params"]).items():
        np.testing.assert_array_equal(TP.flatten_tree(got["params"])[k], v)
        np.testing.assert_array_equal(got["mu"][k], straight["mu"][k])
        np.testing.assert_array_equal(got["nu"][k], straight["nu"][k])
    for k in ("emb", "emb_mu", "emb_nu"):
        np.testing.assert_array_equal(got[k], straight[k])


def test_snapshot_round_trip(toy, tmp_path):
    state = _run(toy, None, 1)
    path = TCK.save_train_state(str(tmp_path), 0, state)
    assert os.path.basename(path) == "state_0000.npz"
    with np.load(path, allow_pickle=False) as npz:  # flat, no pickle
        assert "opt/step" in npz and "params/decoder/up0/kernel" in npz and "__treedef__" not in npz
    snap = TCK.load_train_state(path)
    assert snap["epoch"] == 0 and snap["opt"]["step"] == 2 and snap["emb_opt"]["step"] == 1
    cfg = TrainConfig(**KW)
    fresh = _fresh_state(cfg)
    TCK.restore_train_state(fresh, snap)
    a, b = H.port_state_numpy(fresh), H.port_state_numpy(state)
    for k in ("emb", "emb_mu", "emb_nu"):
        np.testing.assert_array_equal(a[k], b[k])
    for k in b["mu"]:
        np.testing.assert_array_equal(a["mu"][k], b["mu"][k])
        np.testing.assert_array_equal(TP.flatten_tree(a["params"])[k], TP.flatten_tree(b["params"])[k])
    with pytest.raises(ValueError, match="snapshot block axis"):
        TT.train(toy["gt"][:4], toy["dist"][:4], ModelConfig(ch=H.CH, chanstr=H.CHANSTR), cfg, "cpu",
                 checkpoint_dir=str(tmp_path), log=lambda s: None, resume=True)


def _integer_step_snapshot(path, state, epoch):
    """A snapshot in the flat layout with integer steps, written field by
    field, as ``save_train_state`` wrote them before the trainer ran in
    chunks."""
    mu, nu, count = TP.adam_state_to_numpy(state.opt, TP.named_params(state.net))
    emu, enu, ecount = TP.adam_state_to_numpy(state.emb_opt, {"emb": state.emb})
    flat = {f"params/{k}": v for k, v in TP.flatten_tree(TP.params_to_numpy(state.net)).items()}
    flat.update({f"opt/exp_avg/{k}": v for k, v in mu.items()})
    flat.update({f"opt/exp_avg_sq/{k}": v for k, v in nu.items()})
    np.savez(path, **flat, **{"opt/step": np.int64(count), "emb": state.emb.detach().numpy(),
                              "emb_opt/exp_avg": emu["emb"], "emb_opt/exp_avg_sq": enu["emb"],
                              "emb_opt/step": np.int64(ecount), "epoch": np.int64(epoch)})


def test_snapshots_with_either_step_form_resume_alike(toy, tmp_path):
    """An integer-step snapshot written field by field and the one the
    chunked ``train`` writes both resume to epoch 3 and the same state, bit
    for bit."""
    state = _run(toy, str(tmp_path / "new"), 3)
    os.makedirs(tmp_path / "int")
    _integer_step_snapshot(str(tmp_path / "int" / "state_0002.npz"), state, 2)
    cfg = TrainConfig(**{**KW, "epochs": 4})
    got = {}
    for form in ("int", "new"):
        logs = []
        resumed = TT.train(toy["gt"], toy["dist"], ModelConfig(ch=H.CH, chanstr=H.CHANSTR), cfg, "cpu",
                           checkpoint_dir=str(tmp_path / form), log=logs.append, resume=True)[1]
        assert any("resumed from" in x and "state_0002" in x for x in logs) and resumed.epoch == 3
        got[form] = H.port_state_numpy(resumed)
    a, b = got["int"], got["new"]
    assert a["count"] == b["count"] == 8 and a["emb_count"] == b["emb_count"] == 4
    for k, v in TP.flatten_tree(b["params"]).items():
        np.testing.assert_array_equal(TP.flatten_tree(a["params"])[k], v)
        np.testing.assert_array_equal(a["mu"][k], b["mu"][k])
    for k in ("emb", "emb_mu", "emb_nu"):
        np.testing.assert_array_equal(a[k], b[k])


def test_train_divergence_on_non_finite_loss(toy):
    dist = toy["dist"].copy()
    dist[0, 0, 0, 0] = np.inf
    with pytest.raises(TT.TrainDivergence, match="non-finite loss at epoch 0"):
        TT.train(toy["gt"], dist, ModelConfig(ch=H.CH, chanstr=H.CHANSTR), TrainConfig(**KW), "cpu",
                 log=lambda s: None)


def test_latent_guard_warns(toy, monkeypatch):
    assert TT.LATENT_GUARD == JT.LATENT_GUARD == 480.0
    monkeypatch.setattr(TT, "LATENT_GUARD", 0.5)
    with pytest.warns(UserWarning, match="approaching the coder alphabet edge"):
        _run(toy, None, 1)


@pytest.mark.parametrize("epochs", [5, 7])
def test_profile_dir_gets_a_trace_of_epochs_3_to_5(toy, tmp_path, epochs):
    """The window closes after epoch 5, or with the run if that ends first."""
    logs = []
    cfg = TrainConfig(**{**KW, "epochs": epochs, "eval_every": 0})
    TT.train(toy["gt"], toy["dist"], ModelConfig(ch=H.CH, chanstr=H.CHANSTR), cfg, "cpu",
             log=logs.append, profile_dir=str(tmp_path / "prof"))
    assert sum("profiler trace written" in x for x in logs) == 1
    with open(tmp_path / "prof" / "train_trace.json") as f:
        assert "traceEvents" in json.load(f)


def test_other_modes_keep_raising(toy, tmp_path):
    """The name predates the port of the gmm, spatio and factorized modes:
    a tiny gmm run now trains (finite losses, a checkpoint whose entropy
    subtree and metadata are gmm's, which `weights` packs), and only an
    unknown mode raises."""
    logs = []
    cfg = TrainConfig(**{**KW, "epochs": 2, "phase_change": 1, "eval_every": 1})
    spec, state = TT.train(toy["gt"], toy["dist"], ModelConfig(ch=H.CH, chanstr=H.CHANSTR, entropy_mode="gmm"),
                           cfg, "cpu", checkpoint_dir=str(tmp_path), log=logs.append)
    assert spec.entropy_mode == "gmm" and sum(" TRAIN " in x for x in logs) == 2
    params, _, meta = TCK.load_checkpoint_meta(str(tmp_path / "0001.npz"))
    assert meta["entropy_mode"] == "gmm" and set(params["entropy"]) == {"sigma", "mu", "p_logit"}
    assert np.abs(params["entropy"]["p_logit"]).max() > 0  # the mixture weights trained
    from nvfpcc_tpu_torch.cli import main

    assert main(["weights", str(tmp_path / "0001.npz"), "--out", str(tmp_path / "q.npz")]) == 0
    with pytest.raises(ValueError, match="unknown entropy_mode"):
        TT.train(toy["gt"], toy["dist"], ModelConfig(ch=H.CH, chanstr=H.CHANSTR, entropy_mode="banana"),
                 TrainConfig(**KW), "cpu")
