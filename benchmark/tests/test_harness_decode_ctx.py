"""``decode.ctx_vox11`` on the CPU at a small size: a sound run comes out
correct and its two readers read the program's ctx coder spans; a planted
coder fault (``control_decode_ctx.plant``: one decoded latent shifted by
1) and the TF32 control come out not correct; the readers read nothing in
a run of another kind, in a flagship (channel) decode, in an empty store
and in a program without spans."""

import copy
import sys

import pytest
import torch

from benchmark import control_decode_ctx as control
from benchmark.harness import Registry
from benchmark.run import execute

INFO = {"platform": "cpu", "kind": "cpu", "count": 1, "card": "cpu"}
N_BLOCKS = 48
READERS = ("ctx_latents_ms.decode", "ctx_host_share.decode")
HOST_READ = ("decode_mfu", "device_idle_share.decode", "decoder_build_ms.decode", "points_assemble_ms.decode")


def small(reg, name, n_blocks=N_BLOCKS):
    """The cell at ``n_blocks`` blocks, keeping its share of occupied voxels."""
    cell = reg.cell(name)
    cfg = copy.deepcopy(reg.config(cell["config"]))
    share = cfg["n_points"] / (cfg["n_blocks"] * 32**3)
    cfg["n_blocks"], cfg["n_points"] = n_blocks, round(n_blocks * 32**3 * share)
    return cell, cfg


def run_small(name="decode.ctx_vox11", seed=2**33 + 17, trace=False):
    reg = Registry()
    cell, cfg = small(reg, name)
    rc, line = execute(reg, cell, seed, 0.5, trace, torch.device("cpu"), config=cfg, info=INFO)
    assert rc == 0
    return line


@pytest.fixture(autouse=True)
def short_fits_few_threads_and_an_empty_store(short_ctx_fits):
    from nvfpcc_tpu_torch.utils import trace

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(n)


def read(name, obs):
    return Registry().reader(name).read(obs)


def test_a_sound_run_is_correct_and_reads_its_coder():
    line = run_small(trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    # the decode metrics it shares with decode.flagship_vox10 read here too,
    # but for the two that read device time (none on the CPU)
    assert set(line["metrics"]) == set(READERS) | set(HOST_READ)
    assert line["metrics"]["ctx_latents_ms.decode"]["value"] > 0
    assert 0 < line["metrics"]["ctx_host_share.decode"]["value"] < 100


def test_a_planted_coder_fault_is_not_correct(monkeypatch):
    from nvfpcc_tpu_torch.codec import codec

    decode_latent_pack = codec.decode_latent_pack
    monkeypatch.setattr(codec, "decode_latent_pack", lambda *a: control.plant(decode_latent_pack(*a)))
    line = run_small()
    assert not line["correct"] and line["failed"] == line["attempted"]


@pytest.mark.parametrize("seed", [3, 2**40 + 1])
def test_the_control_and_the_fault_fail_the_limit(seed):
    reg = Registry()
    cell, cfg = small(reg, control.CELL)
    limit = reg.limits(control.CELL)["point_gap"]
    numbers = control.readings(cfg, reg.traffic(cell["traffic"]), seed, "cpu")
    assert numbers["program"] <= limit < min(numbers["control_tf32"], numbers["coder_fault"]), numbers


def test_the_readers_read_nothing_in_other_runs(monkeypatch):
    import nvfpcc_tpu_torch.utils as utils

    line = run_small("decode.flagship_vox10", trace=True)  # a channel pack's profiled decodes
    assert line["correct"] and not set(READERS) & set(line["metrics"])
    for name in READERS:
        assert read(name, {"kind": "decode", "stretch_decodes": 2}) is None
        assert read(name, {"kind": "train", "stretch_epochs": 1}) is None
    run_small(trace=True)  # now the store holds ctx spans
    for name in READERS:
        assert read(name, {"kind": "decode", "stretch_decodes": 2}) is not None
        assert read(name, {"kind": "train", "stretch_epochs": 1, "stretch_decodes": 2}) is None
        assert read(name, {"kind": "decode"}) is None  # a run without a profiled stretch
    from nvfpcc_tpu_torch.utils import trace

    trace.reset()
    for name in READERS:
        assert read(name, {"kind": "decode", "stretch_decodes": 2}) is None
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "nvfpcc_tpu_torch.utils.trace", None)
    for name in READERS:
        assert read(name, {"kind": "decode", "stretch_decodes": 2}) is None
