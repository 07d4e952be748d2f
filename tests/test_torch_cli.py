"""The port's CLI and server on the CPU: the toy grids -> encode -> decode
-> eval path through ``nvfpcc_tpu_torch.cli.main`` and ``serve.handle``
from a JAX-written checkpoint, with D1 equal to the JAX ``d1_psnr``; the
whole README workflow (grids -> train -> encode -> decode -> weights) on a
checkpoint the port trained itself; `eval --d2`; plus the refusal of what is
not ported.
(The grids artifact is held against the JAX package in test_torch_grids.py.)"""

import argparse
import io
import json
import os

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


@pytest.mark.parametrize("args,item", [
    pytest.param(["train", "c.ply", "--epochs", "3", "--mesh"], "A16", id="train"),
    # this case held `weights` on a ctx checkpoint, then `train --entropy_mode
    # gmm` (A12); both run now, and it holds `eval --d2` (A10), which runs
    pytest.param(["eval", "a.ply", "b.ply", "--d2", "--depth", "6", "--platform", "cpu"], None, id="weights"),
])
def test_unported_commands_exit_clearly(args, item, tmp_path, capsys):
    """What the CLI still refuses, with its ROADMAP item, before it touches
    the cloud: block-DP (`train --mesh`). `eval --d2` runs, through the CLI
    and through the server (tests/test_torch_d2.py holds its numbers)."""
    if item is None:
        rng = np.random.default_rng(0)
        a = np.unique(rng.integers(20, 28, (60, 3)), axis=0)
        for name, pts in (("a.ply", a), ("b.ply", a + (0, 0, 1))):
            write_ply_points(str(tmp_path / name), pts)
        args = [str(tmp_path / x) if x.endswith(".ply") else x for x in args]
        assert main(args) == 0
        assert "[eval] D2 PSNR" in capsys.readouterr().out
        assert handle({"cmd": args[0], "args": args[1:]}) == {"ok": True, "status": 0}
        assert "[eval] D2 PSNR" in capsys.readouterr().err
        return
    with pytest.raises(SystemExit, match=f"not ported.*ROADMAP {item}"):
        main(args)
    r = handle({"cmd": args[0], "args": args[1:]})
    assert r["ok"] is False and "not ported" in r["error"]


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
