"""The port's headline bench (``nvfpcc_tpu_torch/tools/bench.py``) against the
repo's ``bench.py``: the copied grids, origins and constants equal the
originals; a tiny CPU run (20 blocks, a 1-epoch warm-up chunk and one timed
1-epoch chunk) prints ``bench.py``'s keys in its order, finite values, the
epochs a chunk runs per fetch (ten at the defaults, as ``bench.py``) and
the codec's parity; a non-finite metric row (checked after a chunk's last
epoch) or a decode that differs from the encoder's reconstruction exits 1
without the last line; the options are ``--timed_chunks`` and
``--platform``, and the default is the card."""

import contextlib
import inspect
import io
import json

import numpy as np
import pytest
import torch

import bench as J
from nvfpcc_tpu_torch import codec
from nvfpcc_tpu_torch.tools import bench as B
from nvfpcc_tpu_torch.train import loop as TT
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

# bench.py's last line, in its order (bench.py:125-139)
KEYS = ["metric", "value", "unit", "vs_baseline", "baseline_inferred", "epochs_per_dispatch", "encode_ms",
        "decode_ms"]
TINY = dict(n_blocks=20, chunk_epochs=1)


@pytest.fixture(scope="module")
def flagship_grids():
    """Both packages' 917-block grids; one call each (about 5 s and 1.6 GB
    at its peak)."""
    return J.synthetic_flagship_grids(), B.synthetic_flagship_grids()


def test_synthetic_flagship_grids_equal_the_original(flagship_grids):
    (jgt, jdist), (gt, dist) = flagship_grids
    assert gt.shape == (917, 32, 32, 32) and gt.dtype == jgt.dtype == np.uint8
    assert dist.dtype == jdist.dtype == np.float32
    assert gt.tobytes() == jgt.tobytes() and dist.tobytes() == jdist.tobytes()
    assert 0.01 < gt.mean() < 0.06


@pytest.mark.parametrize("args", [(917,), (20,), (917, 10, 5, 1), (64, 9, 4, 3)])
def test_synthetic_origins_equal_the_original(args):
    got, want = B.synthetic_origins(*args), J.synthetic_origins(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want) and len(got) == args[0]


def test_constants_equal_the_originals():
    for name in ("REF_EPOCH_MS", "N_BLOCKS", "WARMUP_EPOCHS", "TIMED_CHUNKS", "EPOCHS_PER_DISPATCH"):
        assert getattr(B, name) == getattr(J, name), name


def _run(**kw):
    lines = []
    last = B.run_bench("cpu", 1, log=lines.append, **{**TINY, **kw})
    return lines, last


def test_tiny_cpu_run_prints_bench_py_keys_and_parity():
    lines, last = _run()
    assert list(last) == KEYS
    assert last["metric"] == "train_epoch_flagship" and last["unit"] == "ms"
    # a chunk's epochs per fetch; at the defaults bench.py's ten
    assert last["baseline_inferred"] is True and last["epochs_per_dispatch"] == TINY["chunk_epochs"]
    assert inspect.signature(B.run_bench).parameters["chunk_epochs"].default == B.EPOCHS_PER_DISPATCH == 10
    for k in ("value", "vs_baseline", "encode_ms", "decode_ms"):
        assert np.isfinite(last[k]) and last[k] > 0, k
    # from the unrounded epoch time, as bench.py computes it
    assert abs(last["vs_baseline"] - B.REF_EPOCH_MS / last["value"]) < 0.01
    rows = [json.loads(line) for line in lines]
    assert [r["chunk"] for r in rows if "chunk" in r] == [0]
    setup = [r for r in rows if "compute_dtype" in r]
    assert setup == [{"compute_dtype": "bf16", "n_blocks": 20, "batch_size": 16, "q": 2,
                      "peak_device_bytes": None}]
    assert [r["parity"] for r in rows if "parity" in r] == [True]


def test_main_prints_the_card_line_first_and_the_json_line_last(monkeypatch):
    real = B.run_bench
    monkeypatch.setattr(B, "run_bench", lambda device, timed, log: real(device, timed, log=log, **TINY))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert B.main(["--platform", "cpu", "--timed_chunks", "2"]) == 0
    out = buf.getvalue().splitlines()
    assert out[0] == "cpu"
    assert [json.loads(line).get("chunk") for line in out[1:3]] == [0, 1]
    assert list(json.loads(out[-1])) == KEYS


def test_non_finite_metrics_exit_1_without_the_last_line(monkeypatch):
    """The rows are checked once a chunk, after its last epoch: a chunk of
    two epochs on one program runs both, then exits at the first bad one."""
    real, programs = TT.run_epoch, []

    def nan_rows(*a, **k):
        programs.append(k["program"])
        return real(*a, **k) * float("nan")

    monkeypatch.setattr(TT, "run_epoch", nan_rows)
    lines = []
    with pytest.raises(SystemExit, match="non-finite metrics .* at epoch 0 of a chunk") as exc:
        B.run_bench("cpu", 1, log=lines.append, **{**TINY, "chunk_epochs": 2})
    assert str(exc.value).startswith("[bench]") and lines == []
    assert len(programs) == 2 and programs[0] is programs[1]


def test_a_decode_unlike_the_encoder_exits_1(monkeypatch):
    real = codec.decode

    def shifted(pack, device):
        points, info = real(pack, device)
        return np.concatenate([points, np.zeros((1, 3), points.dtype)]), info

    monkeypatch.setattr(codec, "decode", shifted)
    with pytest.raises(SystemExit, match="differ from the encoder's reconstruction"):
        _run()


def test_options_and_the_card_by_default(monkeypatch):
    dests = {a.dest: a.default for a in B.build_parser()._actions if a.dest != "help"}
    assert dests == {"timed_chunks": 3, "platform": "default"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        B.main([])
