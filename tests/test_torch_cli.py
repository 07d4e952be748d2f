"""The port's CLI and server on the CPU: the toy grids -> encode -> decode
-> eval path through ``nvfpcc_tpu_torch.cli.main`` and ``serve.handle``
from a JAX-written checkpoint, with D1 equal to the JAX ``d1_psnr``; the
whole README workflow (grids -> train -> encode -> decode -> weights) on a
checkpoint the port trained itself; `eval --d2`; `train --mesh` on one CPU
rank, which writes plain `train`'s checkpoints, and on two ranks under
`torchrun`, which write those of the same group started in-process.
(The grids artifact is held against the JAX package in test_torch_grids.py.)"""

import argparse
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from nvfpcc_tpu.io.ply import read_ply_points, write_ply_points
from nvfpcc_tpu.metrics import d1_psnr as jax_d1_psnr
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from nvfpcc_tpu_torch.cli import build_parser, main
from nvfpcc_tpu_torch.metrics.d1 import _nn_sq_dists, d1_psnr
from nvfpcc_tpu_torch.serve import handle, serve
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

TOY = ["--depth", "7", "--level", "2", "--platform", "cpu"]


def _toy_cloud(path):
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 2 * np.pi, 2000)
    pts = np.stack([64 + 40 * np.cos(t), 64 + 40 * np.sin(t), 64 + 20 * np.sin(2 * t)], -1)
    pts = np.unique(np.clip(np.rint(pts), 0, 127).astype(np.int64), axis=0)
    write_ply_points(path, pts)
    return pts


def test_serving_path_through_cli_and_serve(tmp_path):
    cloud = str(tmp_path / "toy.ply")
    pts = _toy_cloud(cloud)
    assert main(["grids", cloud] + TOY) == 0
    with np.load(tmp_path / "toy_d7_l2_grids.npz") as art:
        origins, gt = art["origins"], art["gt"]
    assert gt.sum() == len(pts)

    # a JAX-written checkpoint: perturbed init
    spec = JM.build_model_spec(2, (4, 8, 4, 4))
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(spec))
    rng = np.random.default_rng(1)
    for name in JM.TRANSMITTED_KERNELS:
        k = tree["decoder"][name]["kernel"]
        tree["decoder"][name]["kernel"] = (k + rng.integers(-2, 3, k.shape) / 16).astype(np.float32)
    emb = rng.normal(0, 2, (len(origins), 2, 2, 2, 2)).astype(np.float32)
    ckpt = str(tmp_path / "ckpt")
    jax_save_checkpoint(ckpt, 0, tree, emb, meta={"ch": 2, "chanstr": "4,8,4,4", "entropy_mode": "channel"})

    pack, rc_enc, rc_dec = (str(tmp_path / n) for n in ("pack.pk", "rc_enc.ply", "rc_dec.ply"))
    r = handle({"cmd": "encode", "args": [cloud, "--load_checkpoint", ckpt, "--pack_fn", pack,
                                          "--recon", rc_enc, "--thh", "0.55"] + TOY})
    assert r == {"ok": True, "status": 0}
    r = handle({"cmd": "decode", "args": [pack, "--recon", rc_dec, "--platform", "cpu"]})
    assert r == {"ok": True, "status": 0}
    with open(rc_enc, "rb") as a, open(rc_dec, "rb") as b:
        assert a.read() == b.read()
    rec = np.rint(read_ply_points(rc_dec)).astype(np.int64)
    assert len(rec) > 0

    out = io.StringIO()
    serve(io.StringIO(json.dumps({"cmd": "eval", "args": [cloud, rc_dec] + TOY}) + "\n"), out)
    assert json.loads(out.getvalue()) == {"ok": True, "status": 0}
    want = jax_d1_psnr(pts, rec, depth=7, platform="cpu")
    got = d1_psnr(pts, rec, depth=7, device="cpu")
    assert got == want


def test_nn_sq_dists_match_brute_force():
    from nvfpcc_tpu_torch.grids.edt import brute_force_sq_dist

    rng = np.random.default_rng(0)
    a = np.unique(rng.integers(0, 40, (200, 3)), axis=0)
    b = np.unique(rng.integers(0, 40, (150, 3)), axis=0)
    np.testing.assert_array_equal(_nn_sq_dists(a, b, 70, "cpu"), brute_force_sq_dist(a, b))
    assert d1_psnr(a, a, depth=6, device="cpu")["psnr"] == float("inf")


def test_parser_is_flag_compatible_with_the_jax_cli():
    ap = build_parser()
    ap.parse_args(["grids", "c.ply", "--depth", "7", "--level", "2", "--platform", "device"])
    ap.parse_args(["encode", "c.ply", "--load_checkpoint", "d", "--pack_fn", "p.pk", "--thh", "0.6",
                   "--qp", "16", "--platform", "cpu", "--entropy_mode", "auto", "--ch", "3",
                   "--chanstr", "8,16,8,8", "--recon", "r.ply"])
    ap.parse_args(["decode", "p.pk", "--recon", "out.ply", "--thh", "0.5"])
    ap.parse_args(["eval", "a.ply", "b.ply", "--depth", "10"])
    ap.parse_args(["weights", "ck.npz", "--out", "q.npz", "--qp", "16"])
    from nvfpcc_tpu.cli import build_parser as jax_build_parser

    def train_flags(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {a.dest: (a.default, a.choices, a.type) for a in sub.choices["train"]._actions
                if a.dest != "platform"}

    assert train_flags(ap) == train_flags(jax_build_parser())


@pytest.mark.parametrize("args,expect", [
    # this case held the refusal of `train --mesh` (A16); block-DP runs now,
    # here as one gloo rank on the CPU
    pytest.param(["train", "toy.ply", "--epochs", "1", "--eval_every", "0", "--mesh", "--ch", "2",
                  "--chanstr", "4,8,4,4"] + TOY, "[train] block-DP mesh over 1 devices", id="train"),
    # this case held `weights` on a ctx checkpoint, then `train --entropy_mode
    # gmm` (A12); both run now, and it holds `eval --d2` (A10), which runs
    pytest.param(["eval", "a.ply", "b.ply", "--d2", "--depth", "6", "--platform", "cpu"], "[eval] D2 PSNR",
                 id="weights"),
])
def test_unported_commands_exit_clearly(args, expect, tmp_path, capsys):
    """The name predates the last ports: the CLI refuses nothing the JAX CLI
    accepts. Each former refusal runs, through the CLI and through the
    server: `train --mesh` (tests/test_torch_parallel.py holds its
    numbers) and `eval --d2` (tests/test_torch_d2.py holds them)."""
    rng = np.random.default_rng(0)
    a = np.unique(rng.integers(20, 28, (60, 3)), axis=0)
    for name, pts in (("a.ply", a), ("b.ply", a + (0, 0, 1))):
        write_ply_points(str(tmp_path / name), pts)
    _toy_cloud(str(tmp_path / "toy.ply"))
    args = [str(tmp_path / x) if x.endswith(".ply") else x for x in args]
    if args[0] == "train":
        args += ["--checkpoint_dir", str(tmp_path / "ckpt")]
    assert main(args) == 0
    assert expect in capsys.readouterr().out
    assert handle({"cmd": args[0], "args": args[1:]}) == {"ok": True, "status": 0}
    assert expect in capsys.readouterr().err


def test_train_mesh_on_cpu_writes_the_plain_checkpoint(tmp_path, capsys):
    """`train --mesh --platform cpu` runs one gloo rank: it prints the mesh
    line and the block-DP line, and writes the checkpoints and snapshots of
    plain `train`, array for array (world size 1 is the same arithmetic)."""
    cloud = str(tmp_path / "toy.ply")
    _toy_cloud(cloud)
    flags = ["--epochs", "2", "--phase_change", "1", "--eval_every", "1", "--batchsize", "4", "--ch", "2",
             "--chanstr", "4,8,4,4"] + TOY
    assert main(["train", cloud, "--checkpoint_dir", str(tmp_path / "plain")] + flags) == 0
    capsys.readouterr()
    assert main(["train", cloud, "--checkpoint_dir", str(tmp_path / "mesh"), "--mesh"] + flags) == 0
    out = capsys.readouterr().out
    assert "[train] block-DP mesh over 1 devices" in out and "block-DP over 1 ranks (gloo, cpu)" in out
    assert out.count(" TRAIN ") == 2
    files = sorted(os.listdir(tmp_path / "plain"))
    assert files == sorted(os.listdir(tmp_path / "mesh")) == [
        "0000.npz", "0001.npz", "state_0000.npz", "state_0001.npz"]
    for f in files:
        with np.load(tmp_path / "plain" / f) as want, np.load(tmp_path / "mesh" / f) as got:
            assert sorted(want) == sorted(got)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{f}: {k}")


def test_train_mesh_under_torchrun_equals_run_group(tmp_path):
    """`torchrun --nproc_per_node 2 -m nvfpcc_tpu_torch.cli train --mesh`:
    the ranks join the group torchrun describes, rank 1 waits for rank 0's
    grids, and the last checkpoint and snapshot equal, array for array,
    those of a 2-rank group that ``parallel.run_group`` starts on the same
    grids and flags."""
    from nvfpcc_tpu_torch.cli import load_or_build_artifacts, train_job
    from nvfpcc_tpu_torch.parallel import run_group
    from nvfpcc_tpu_torch.train.loop import train_on_mesh

    cloud = str(tmp_path / "toy.ply")
    _toy_cloud(cloud)
    flags = ["--epochs", "2", "--phase_change", "1", "--eval_every", "1", "--batchsize", "4", "--ch", "2",
             "--chanstr", "4,8,4,4", "--mesh"] + TOY
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "nvfpcc_tpu_torch.cli", "train", cloud, "--checkpoint_dir", str(tmp_path / "torchrun")] + flags,
        cwd=root, env={**os.environ, "OMP_NUM_THREADS": "1"}, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("[train] block-DP mesh over 2 devices") == 1 and r.stdout.count(" TRAIN ") == 2
    assert "block-DP over 2 ranks (gloo, cpu)" in r.stdout

    args = build_parser().parse_args(["train", cloud, "--checkpoint_dir", str(tmp_path / "group")] + flags)
    job = train_job(args, load_or_build_artifacts(cloud, 7, 2, torch.device("cpu")), log=lambda line: None)
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # the spawned rank reads it at start
    try:
        run_group(train_on_mesh, 2, "gloo", ["cpu"] * 2, args=([job],), timeout_s=300)
    finally:
        if threads is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    files = sorted(os.listdir(tmp_path / "group"))
    assert files == sorted(os.listdir(tmp_path / "torchrun")) == [
        "0000.npz", "0001.npz", "state_0000.npz", "state_0001.npz"]
    for f in files[1::2]:
        with np.load(tmp_path / "group" / f) as want, np.load(tmp_path / "torchrun" / f) as got:
            assert sorted(want) == sorted(got)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{f}: {k}")


def test_train_then_encode_decode_in_one_process(tmp_path, capsys):
    """The README workflow on the CPU with a tiny model: 2 epochs of `train`
    (one q=1, one q=2, bf16 default), then `encode`/`decode` parity and
    `weights` in the same process. Training's cuDNN settings must not reach
    the codec: it pins its own before it reconstructs."""
    cloud = str(tmp_path / "toy.ply")
    _toy_cloud(cloud)
    ckpt, metrics = str(tmp_path / "ckpt"), str(tmp_path / "m.jsonl")
    small = ["--ch", "2", "--chanstr", "4,8,4,4"]
    assert main(["train", cloud, "--epochs", "2", "--phase_change", "1", "--eval_every", "1",
                 "--batchsize", "4", "--checkpoint_dir", ckpt, "--metrics", metrics] + small + TOY) == 0
    assert torch.backends.cudnn.deterministic is False  # what training set
    out = capsys.readouterr().out
    assert "entropy_mode auto -> channel" in out and out.count("TRAIN") == 2 and out.count("TEST]") == 2
    rows = [json.loads(line) for line in open(metrics)]
    assert [(r["epoch"], r["q"]) for r in rows] == [(0, 1), (1, 2)]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert sorted(os.listdir(ckpt)) == ["0000.npz", "0001.npz", "state_0000.npz", "state_0001.npz"]

    pack, rc_enc, rc_dec = (str(tmp_path / n) for n in ("pack.pk", "rc_enc.ply", "rc_dec.ply"))
    assert main(["encode", cloud, "--load_checkpoint", ckpt, "--pack_fn", pack, "--recon", rc_enc,
                 "--thh", "0.3"] + TOY) == 0
    assert torch.backends.cudnn.deterministic is True and not torch.backends.cudnn.allow_tf32
    assert main(["decode", pack, "--recon", rc_dec, "--platform", "cpu"]) == 0
    with open(rc_enc, "rb") as a, open(rc_dec, "rb") as b:
        assert a.read() == b.read()
    assert len(read_ply_points(rc_dec)) > 0

    # resume runs one more epoch from the snapshot of epoch 1
    assert main(["train", cloud, "--epochs", "3", "--phase_change", "1", "--eval_every", "1",
                 "--batchsize", "4", "--checkpoint_dir", ckpt, "--resume"] + small + TOY) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and out.count("TRAIN") == 1 and os.path.exists(os.path.join(ckpt, "0002.npz"))

    qck = str(tmp_path / "q" / "quant.npz")
    assert main(["weights", os.path.join(ckpt, "0001.npz"), "--out", qck]) == 0
    out = capsys.readouterr().out
    assert "lossless round-trip OK" in out and "b/residual" in out
    with np.load(qck) as npz:
        k = npz["decoder/up0/kernel"] * 16
        assert np.array_equal(k, np.rint(k)) and "__emb__" in npz


def test_train_auto_resolving_to_ctx_exits_with_its_item(tmp_path, monkeypatch):
    """`auto` picks ctx at level >= 6 above the symbol break-even: on the
    vox11 sphere's 5,326 blocks at level 6 the trainer starts in ctx mode
    (zero predictor init, hidden 8, no tail), as the JAX CLI decides. The
    name predates the ctx port, when this exited with ROADMAP A13."""
    from nvfpcc_tpu.cli import resolve_auto_train as jax_resolve_auto_train
    from nvfpcc_tpu_torch import cli
    from nvfpcc_tpu_torch.train import loop

    fake = {"origins": np.zeros((5326, 3), np.int64), "gt": None, "dist": None}
    monkeypatch.setattr(cli, "load_or_build_artifacts", lambda *a, **k: fake)
    seen = {}
    monkeypatch.setattr(loop, "train", lambda gt, dist, mcfg, cfg, device, **k: seen.update(mcfg=mcfg))
    assert main(["train", "c.ply", "--depth", "11", "--level", "6", "--platform", "cpu"]) == 0
    m = seen["mcfg"]
    assert (m.entropy_mode, m.ctx_hidden, m.ctx_tail, m.ctx_train_init) == ("ctx", 8, 0, "zero")
    assert jax_resolve_auto_train(6, 5326 * 3 * 8) == "ctx"
    assert main(["train", "c.ply", "--entropy_mode", "ctx_ar", "--ctx_tail", "2", "--platform", "cpu"]) == 0
    assert (seen["mcfg"].entropy_mode, seen["mcfg"].ctx_tail) == ("ctx_ar", 2)


def test_bad_requests():
    assert handle({})["ok"] is False
    assert handle({"cmd": 5})["ok"] is False
    assert handle({"cmd": "eval", "args": [1, 2]})["ok"] is False
    assert handle({"cmd": "nonsense"})["ok"] is False


def test_device_platform_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cloud = str(tmp_path / "toy.ply")
    _toy_cloud(cloud)
    r = handle({"cmd": "grids", "args": [cloud, "--depth", "7", "--level", "2"]})
    assert r["ok"] is False and "needs a CUDA device" in r["error"]
    assert not os.path.exists(tmp_path / "toy_d7_l2_grids.npz")


@pytest.mark.parametrize("deterministic", [False, True])
def test_train_numerics_keep_deterministic_algorithms(deterministic):
    """Training leaves cuDNN's algorithms free unless the caller turned on
    deterministic algorithms, as ``chip_smoke.py`` does for the runs whose
    checkpoints it compares bit for bit."""
    from nvfpcc_tpu_torch.device import set_train_numerics

    before = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(deterministic)
    try:
        set_train_numerics()
        assert torch.backends.cudnn.deterministic is deterministic and not torch.backends.cudnn.allow_tf32
    finally:
        torch.use_deterministic_algorithms(before[0])
        torch.backends.cudnn.deterministic = before[1]
