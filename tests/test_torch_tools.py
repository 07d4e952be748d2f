"""The port's workflow tools (``nvfpcc_tpu_torch/tools/{rd_sweep,encode_eval,
pipeline_demo}.py``) on the CPU, against the JAX scripts they port
(``scripts/{rd_sweep,encode_eval,pipeline_demo}.py``): the same options
(plus ``--platform``); an ``rd_sweep`` row equal to what the JAX script
computes for the same checkpoint (bit counts exactly, points within the
1e-4 ``thh`` band, D1/D2 on the same points within 1e-9 relative); the
sweep loop, resumable; ``encode_eval``'s pack equal to ``cli encode``'s;
``pipeline_demo`` to parity. The toy width (ch=2, chanstr 4,8,4,4), apart
from ``pipeline_demo``, which trains the flagship width as the JAX script
does, on a depth-7 / level-2 toy cloud held to two blocks: D1 and D2 run
the EDT over the clouds' bounding box grown by the 63-voxel window, so on
the CPU each score costs about 2 s here against 5 s on the 14-block toy of
the codec tests, and the sweep scores eight rows."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from nvfpcc_tpu import codec as JC
from nvfpcc_tpu.config import CodecConfig as JaxCodecConfig
from nvfpcc_tpu.config import ModelConfig as JaxModelConfig
from nvfpcc_tpu.metrics import d1_psnr as jax_d1_psnr
from nvfpcc_tpu.metrics import d2_psnr as jax_d2_psnr
from nvfpcc_tpu.utils import checkpoint as JCK
from nvfpcc_tpu_torch.cli import load_or_build_artifacts
from nvfpcc_tpu_torch.cli import main as cli_main
from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.io.ply import write_ply_points
from nvfpcc_tpu_torch.tools import encode_eval, pipeline_demo, rd_sweep
from nvfpcc_tpu_torch.tools.ctx_recipe import threshold_keeping
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import checkpoint as TCK
import torch_train_helpers as H
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY_MCFG = ModelConfig(ch=H.CH, chanstr=H.CHANSTR)
DEPTH, LEVEL = 7, 2
TOY = ["--depth", str(DEPTH), "--level", str(LEVEL), "--platform", "cpu"]
BAND = 1e-4
TOOLS = {"rd_sweep": rd_sweep, "encode_eval": encode_eval, "pipeline_demo": pipeline_demo}
# the JAX scripts' output keys, in their order
RD_KEYS = ["lambda", "thh", "bpp", "b_latent", "b_net", "b_origins", "d1_psnr", "d1_mse", "d2_psnr",
           "n_points_rec", "n_points_src", "train_s"]
ENCODE_EVAL_KEYS = ["encode_s", "decode_s", "parity", "n_points_rec", "d1_psnr", "d2_psnr", "pack_bytes",
                    "bpp", "entropy_mode", "b_latent_stream", "ctx_post"]
PIPELINE_KEYS = ["grids_s", "train_s", "encode_s", "decode_s", "total_s", "parity", "n_points_rec", "d1_psnr",
                 "d2_psnr", "pack_bytes", "bpp", "entropy_mode", "epochs", "lambda"]


def _toy_cloud(path):
    """A ring through the blocks at (0, 0, 0) and (32, 0, 0)."""
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 2 * np.pi, 2000)
    pts = np.stack([32 + 26 * np.cos(t), 16 + 12 * np.sin(t), 16 + 6 * np.sin(2 * t)], -1)
    pts = np.unique(np.rint(pts).astype(np.int64), axis=0)
    write_ply_points(path, pts)
    return pts


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """The toy cloud and its grids, and a 2-epoch port checkpoint of it at
    the toy width (the last epoch checkpointed), with two thresholds that
    keep about 1x and 4x the cloud's points."""
    d = tmp_path_factory.mktemp("tools")
    cloud = str(d / "toy.ply")
    pts = _toy_cloud(cloud)
    art = load_or_build_artifacts(cloud, DEPTH, LEVEL, "cpu", log=lambda line: None)
    ckpt = str(d / "ckpt")
    TT.train(art["gt"], art["dist"], TOY_MCFG, TrainConfig(epochs=2, eval_every=1), "cpu",
             checkpoint_dir=ckpt, log=lambda line: None)
    thhs = [threshold_keeping(ckpt, k * len(pts), "cpu") for k in (1, 4)]
    assert thhs[0] > thhs[1]
    return types.SimpleNamespace(dir=d, cloud=cloud, pts=pts, art=art, ckpt=ckpt, thhs=thhs)


# A process that runs a script up to its ``parse_args`` and prints the
# parser's options; the JAX scripts parse before importing jax, which the
# process blocks.
_DUMP = """
import argparse, json, runpy, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "nvfpcc_tpu"):
            raise ImportError(name + " is blocked")

sys.meta_path.insert(0, BlockJax())

def dump(self, args=None, namespace=None):
    print(json.dumps({a.dest: [a.option_strings, repr(a.default), a.required]
                      for a in self._actions if a.dest != "help"}))
    sys.exit(0)

argparse.ArgumentParser.parse_args = dump
path = sys.argv[1]
sys.argv = [path]
runpy.run_path(path, run_name="__main__")
"""


@pytest.mark.parametrize("name", ["rd_sweep", "encode_eval", "pipeline_demo"])
def test_options_are_the_jax_scripts_plus_platform(name):
    r = subprocess.run([sys.executable, "-c", _DUMP, os.path.join(ROOT, "scripts", f"{name}.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    want = json.loads(r.stdout)
    tool = TOOLS[name]
    got = {a.dest: [a.option_strings, repr(a.default), a.required]
           for a in tool.build_parser()._actions if a.dest != "help"}
    assert {k: got.get(k) for k in want} == want
    assert set(got) - set(want) == {"platform"}
    assert got["platform"] == [["--platform"], repr("default"), False]


@pytest.mark.parametrize("name,argv", [("rd_sweep", ["cloud.ply"]), ("encode_eval", ["cloud.ply", "--ckpt", "c"]),
                                       ("pipeline_demo", [])])
def test_tools_run_on_the_card_unless_told_cpu(name, argv, monkeypatch):
    """Without a card the default platform raises before any work: nothing
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        TOOLS[name].main(argv)


@pytest.mark.parametrize("which,no_d2", [(0, False), (1, True)])
def test_rd_sweep_row_equals_the_jax_scripts(toy, which, no_d2):
    """The row the port's sweep makes for a checkpoint against what
    ``scripts/rd_sweep.py`` computes for the same checkpoint file:
    ``nvfpcc_tpu.codec.encode`` and its ``d1_psnr``/``d2_psnr``."""
    thh = toy.thhs[which]
    path = TCK.latest_checkpoint(toy.ckpt)
    tparams, temb = TCK.load_checkpoint(path)
    row, result = rd_sweep.encode_row(tparams, temb, toy.art, toy.pts, TOY_MCFG, 200.0, thh, 12.34, DEPTH, LEVEL,
                                      torch.device("cpu"), torch.device("cpu"), no_d2)
    assert list(row) == [k for k in RD_KEYS if not (no_d2 and k == "d2_psnr")]
    jparams, jemb = JCK.load_checkpoint(path)
    n_points = int(toy.art["gt"].sum())
    jres = JC.encode(H.jtree(jparams), jemb, toy.art["origins"], JaxModelConfig(ch=H.CH, chanstr=H.CHANSTR),
                     JaxCodecConfig(thh_encode=thh, thh_decode=thh, depth=DEPTH, level=LEVEL), n_points)
    for k in ("b_net", "b_latent", "b_origins", "bpp", "n_points_src"):
        assert row[k] == jres.stats[k], k
    assert row["n_points_src"] == n_points == len(toy.pts)
    assert row["lambda"] == 200.0 and row["thh"] == thh and row["train_s"] == 12.3
    H.assert_only_band_differs(result.points, np.asarray(jres.points), result.pack, BAND)
    assert row["n_points_rec"] == len(result.points) > 0
    want = jax_d1_psnr(toy.pts, result.points, DEPTH, platform="cpu")
    np.testing.assert_allclose(row["d1_psnr"], want["psnr"], rtol=1e-9)
    np.testing.assert_allclose(row["d1_mse"], want["mse"], rtol=1e-9)
    if not no_d2:
        want = jax_d2_psnr(toy.pts, result.points, DEPTH, platform="cpu")
        np.testing.assert_allclose(row["d2_psnr"], want["psnr"], rtol=1e-9)


def test_rd_sweep_loop_and_its_rerun(toy, tmp_path, monkeypatch, capsys):
    """2 lambdas x 2 thresholds: four rows with the JAX script's keys; a
    rerun into the same workdir resumes each lambda from its snapshot,
    trains no epoch and appends the same rows. One epoch a lambda: the
    trainer snapshots every 10 epochs from epoch 0, so the last epoch of a
    1-epoch (or 501-epoch) run has a snapshot to resume from."""
    # thresholds read off a probe of the first lambda's 1-epoch model
    art = toy.art
    TT.train(art["gt"], art["dist"], TOY_MCFG, TrainConfig(lmbda=100.0, epochs=1), "cpu",
             checkpoint_dir=str(tmp_path / "probe"), log=lambda line: None)
    thhs = [threshold_keeping(str(tmp_path / "probe"), k * len(toy.pts), "cpu") for k in (2, 8)]
    epochs_run = []
    real_run_epoch = TT.run_epoch
    monkeypatch.setattr(TT, "run_epoch", lambda *a, **k: epochs_run.append(1) or real_run_epoch(*a, **k))
    out, work = str(tmp_path / "rd.jsonl"), str(tmp_path / "work")

    def run():
        return rd_sweep.sweep(toy.cloud, [100.0, 400.0], thhs, 1, work, out, TOY_MCFG, "cpu",
                              depth=DEPTH, level=LEVEL, no_d2=True)

    first = run()
    assert len(epochs_run) == 2
    for lmbda in ("l100", "l400"):
        assert os.path.exists(os.path.join(work, lmbda, "state_0000.npz"))
    epochs_run.clear()
    again = run()
    assert epochs_run == []
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    assert lines == first + again and len(first) == 4
    keys = [k for k in RD_KEYS if k != "d2_psnr"]
    assert [list(r) for r in lines] == [keys] * 8
    assert [(r["lambda"], r["thh"]) for r in first] == [(lm, t) for lm in (100.0, 400.0) for t in thhs]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "train_s"} for r in rows]  # noqa: E731
    assert strip(again) == strip(first)
    for r in first:
        assert r["n_points_rec"] > 0 and np.isfinite(r["d1_psnr"])
        assert abs(r["bpp"] - (r["b_net"] + r["b_latent"] + r["b_origins"])) < 1e-12
    assert capsys.readouterr().out.count("[rd] lambda=") == 8


def test_rd_sweep_fails_clearly_on_an_empty_reconstruction(toy):
    params, emb = TCK.load_checkpoint(TCK.latest_checkpoint(toy.ckpt))
    with pytest.raises(SystemExit, match="the reconstruction is empty"):
        rd_sweep.encode_row(params, emb, toy.art, toy.pts, TOY_MCFG, 200.0, 0.999, 0.0, DEPTH, LEVEL,
                            torch.device("cpu"), torch.device("cpu"), no_d2=True)


def test_encode_eval_matches_cli_encode(toy, tmp_path, capsys):
    """One JSON line with the JAX script's keys, parity, ``bpp`` from the
    pack's bytes, and the pack ``cli encode`` writes with the same flags."""
    ckpt = str(tmp_path / "run" / "ckpt")
    shutil.copytree(toy.ckpt, ckpt)
    thh = str(toy.thhs[0])
    capsys.readouterr()
    assert encode_eval.main([toy.cloud, "--ckpt", ckpt, "--thh", thh, *TOY]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(stats) == ENCODE_EVAL_KEYS
    assert stats["parity"] is True and stats["n_points_rec"] > 0 and stats["ctx_post"] is False
    pack = str(tmp_path / "run" / "pack.pk")
    assert stats["pack_bytes"] == os.path.getsize(pack)
    assert stats["bpp"] == round(8 * stats["pack_bytes"] / len(toy.pts), 4)
    assert np.isfinite(stats["d1_psnr"]) and np.isfinite(stats["d2_psnr"])
    want = str(tmp_path / "cli_pack.pk")
    assert cli_main(["encode", toy.cloud, *TOY, "--load_checkpoint", ckpt, "--entropy_mode", "channel",
                     "--pack_fn", want, "--thh", thh, "--ctx_hidden", "8"]) == 0
    with open(pack, "rb") as a, open(want, "rb") as b:
        assert a.read() == b.read()


def test_encode_eval_without_a_checkpoint_exits_nonzero(toy, tmp_path):
    os.makedirs(tmp_path / "empty")
    with pytest.raises(SystemExit, match="no checkpoints in") as e:
        encode_eval.main([toy.cloud, "--ckpt", str(tmp_path / "empty"), "--thh", "0.5", *TOY])
    assert e.value.code not in (0, None)
    assert not os.path.exists(tmp_path / "pack.pk")


def test_pipeline_demo_runs_to_parity(toy, tmp_path, capsys):
    """grids -> train -> encode -> decode at the flagship width on the toy
    cloud (its grids are cached beside it), at a threshold read off the
    checkpoint encode takes (epoch 0's: the trainer checkpoints every 10)."""
    TT.train(toy.art["gt"], toy.art["dist"], ModelConfig(), TrainConfig(epochs=1), "cpu",
             checkpoint_dir=str(tmp_path / "probe"), log=lambda line: None)
    thh = threshold_keeping(str(tmp_path / "probe"), 4 * len(toy.pts), "cpu")
    capsys.readouterr()
    work = str(tmp_path / "work")
    assert pipeline_demo.main(["--cloud", toy.cloud, "--epochs", "2", "--thh", str(thh), "--workdir", work,
                               *TOY]) == 0
    out = capsys.readouterr().out
    stats = json.loads([line for line in out.splitlines() if line.startswith("{")][-1])
    assert list(stats) == PIPELINE_KEYS
    assert stats["parity"] is True and stats["n_points_rec"] > 0
    assert np.isfinite(stats["d1_psnr"]) and np.isfinite(stats["d2_psnr"])
    assert stats["epochs"] == 2 and stats["lambda"] == 200.0 and stats["entropy_mode"] == "channel"
    assert "UNDER the 10-min north star" in out
    assert TCK.load_checkpoint_meta(TCK.latest_checkpoint(os.path.join(work, "ckpts")))[2]["chanstr"] == "8,16,8,8"
