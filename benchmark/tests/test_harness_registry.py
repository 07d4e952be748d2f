"""A cell, a configuration, a traffic mix, a driver and a per-layer metric
that a later change adds as new files and ``BENCHMARK.json`` entries are
found by name, and run end to end, with no file of the benchmark edited."""

import json
import os
import shutil

import torch

from benchmark.harness import Outcome, Registry, banned_loaded, result_line
from benchmark.run import execute

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DRIVER = '''
from benchmark.harness import Outcome


def run(ctx):
    v = float(ctx.config["size"]) * ctx.traffic["rate"]
    return Outcome(end_to_end={"echo_ms": v, "setup_s": 0.5}, checks={"echo_gap": 0.0}, attempted=3, failed=0,
                   memory_peak_bytes=7, obs={"kind": "echo", "v": v}, busy_s=0.1, window_s=0.2)
'''
READER = '''
def read(obs):
    return obs["v"] * 2 if obs.get("kind") == "echo" else None
'''


def copy_with_new_cell(tmp) -> str:
    root = str(tmp)
    shutil.copytree(os.path.join(ROOT, "benchmark"), os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    b = os.path.join(root, "benchmark")
    files = {
        "configs/echo_cfg.json": json.dumps({"size": 4}),
        "traffic/echo_mix.json": json.dumps({"driver": "echo", "rate": 2.5}),
        "drivers/echo.py": DRIVER,
        "metrics/echo_layer_ms.py": READER,
        "limits/echo.cell.json": json.dumps({"echo_gap": 0.0}),
    }
    for rel, text in files.items():
        with open(os.path.join(b, rel), "x") as f:  # new files only
            f.write(text)
    spec["configs"].append({"name": "echo_cfg", "source": "https://example.org/echo", "file": "benchmark/configs/echo_cfg.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "echo.cell", "config": "echo_cfg", "traffic": "echo_mix", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "echo_ms", "unit": "ms", "better": "lower", "bound": 0.05,
                               "source": "host_clock", "workloads": ["echo.cell"]})
    spec["per_layer"].append({"name": "echo_layer_ms", "unit": "ms", "better": "lower", "source": "program_span",
                              "layer": "echo", "moves": "echo_ms", "workloads": ["echo.cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def test_new_files_are_found_by_name(tmp_path, capsys):
    reg = Registry(root=copy_with_new_cell(tmp_path))
    cell = reg.cell("echo.cell")
    assert reg.config("echo_cfg") == {"size": 4}
    assert reg.traffic("echo_mix")["driver"] == "echo"
    assert sorted(m["name"] for m in reg.end_to_end("echo.cell")) == ["echo_ms", "setup_s"]
    assert [m["name"] for m in reg.per_layer("echo.cell")] == ["echo_layer_ms"]
    info = {"platform": "cpu", "kind": "cpu", "count": 1, "card": "cpu"}
    rc, line = execute(reg, cell, 1, 1.0, False, torch.device("cpu"), info=info)
    assert rc == 0 and line["correct"] and line["metrics"] == {
        "echo_ms": {"value": 10.0, "unit": "ms"}, "setup_s": {"value": 0.5, "unit": "s"}}
    rc, line = execute(reg, cell, 1, 1.0, True, torch.device("cpu"), info=info)
    assert line["metrics"] == {"echo_layer_ms": {"value": 20.0, "unit": "ms"}}
    assert line["device"]["busy_s"] == 0.1 and list(line)[-1] == "checks"
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == line
    # the cells already there keep their metrics
    assert "echo_layer_ms" not in [m["name"] for m in reg.per_layer("train.flagship_vox10")]


def test_result_line_decides_correct_by_the_limits():
    reg = Registry()
    out = Outcome(end_to_end={"decode_ms": 800.0, "setup_s": 12.0}, checks={"point_gap": 2e-5}, attempted=30,
                  failed=0, memory_peak_bytes=1)
    line = result_line(reg, "decode.flagship_vox10", out, {"point_gap": 1e-5}, False, {"platform": "gpu"})
    assert not line["correct"] and line["checks"]["point_gap"] == {"value": 2e-5, "limit": 1e-5}
    line = result_line(reg, "decode.flagship_vox10", out, {"point_gap": 1e-4}, False, {"platform": "gpu"})
    assert line["correct"] and set(line["metrics"]) == {"decode_ms", "setup_s"}
    out.failed = 1
    assert not result_line(reg, "decode.flagship_vox10", out, {"point_gap": 1e-4}, False, {})["correct"]


def test_banned_names_compare_whole():
    assert banned_loaded(["nvfpcc_tpu_torch", "nvfpcc_tpu_torch.codec", "jaxtyping", "flaxen"]) == []
    assert banned_loaded(["nvfpcc_tpu.models.decoder", "jax.numpy", "jaxlib"]) == ["jax", "jaxlib", "nvfpcc_tpu"]
