"""What the benchmark finds by name, and what every run prints.

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; the files behind the names are found here:

- a configuration: the ``file`` its entry names (``benchmark/configs/``);
- a traffic mix: ``benchmark/traffic/<traffic>.json``, which names its
  driver, ``benchmark/drivers/<driver>.py`` (a function ``run(ctx)``);
- a cell's limits on the numbers that decide ``correct``:
  ``benchmark/limits/<cell>.json``;
- a per-layer metric: ``benchmark/metrics/<metric>.py`` (a function
  ``read(obs)`` that returns a number, or None when the run gave it
  nothing to read).

A later cell, configuration, traffic mix, driver or metric is one more
file and one more entry; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run (compared whole:
# the program's name begins with the JAX package's)
BANNED = ("jax", "jaxlib", "flax", "nvfpcc_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Registry:
    """The benchmark's names and the files behind them, under ``root``."""

    root: str = ROOT
    spec: dict = field(default=None)

    def __post_init__(self):
        if self.spec is None:
            self.spec = _json(os.path.join(self.root, "BENCHMARK.json"))
        self.bench = os.path.join(self.root, "benchmark")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(os.path.join(self.bench, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return _json(os.path.join(self.bench, "limits", f"{cell}.json"))

    def driver(self, kind: str):
        return _module(os.path.join(self.bench, "drivers", f"{kind}.py"), f"benchmark_driver_{kind}")

    def reader(self, metric: str):
        return _module(os.path.join(self.bench, "metrics", f"{metric}.py"), f"benchmark_metric_{metric}")

    def _applies(self, entry: dict, cell: str) -> bool:
        return "workloads" not in entry or cell in entry["workloads"]

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"] if self._applies(m, cell)]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.spec["per_layer"] if self._applies(m, cell)]


def banned_loaded(modules=None) -> list:
    """The banned top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(BANNED))


@dataclass
class Outcome:
    """What a driver hands back: the window's numbers, the checks, and the
    observations the per-layer readers read (``obs``)."""

    end_to_end: dict  # name -> value (the driver's end-to-end metrics, setup_s included)
    checks: dict  # name -> value, compared with the cell's limits
    attempted: int
    failed: int
    memory_peak_bytes: int
    obs: dict = field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None


def result_line(reg: Registry, cell: str, out: Outcome, limits: dict, trace: bool, device: dict) -> dict:
    """The contract's last line. ``correct`` holds when every check is at
    or under its limit and no attempt failed; the checks come last."""
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in out.checks.items()}
    missing = sorted(set(limits) - set(out.checks))
    correct = not missing and out.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if trace:
        for m in reg.per_layer(cell):
            value = reg.reader(m["name"]).read(out.obs)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in reg.end_to_end(cell):
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]}
    dev = {**device, "memory_peak_bytes": int(out.memory_peak_bytes)}
    if trace:
        dev.update(busy_s=out.busy_s, window_s=out.window_s)
    line = {"correct": bool(correct), "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": dev}
    if trace and out.breakdown:
        line["breakdown"] = out.breakdown
    line["checks"] = checks
    return line


def card_name(device) -> dict:
    """The contract's device fields and the card's power limit."""
    import subprocess

    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout.strip()
        info["card"] = smi.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        info["card"] = "power limit not read"
    return info


@dataclass
class Context:
    """One run of one cell, as a driver gets it."""

    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float  # time.perf_counter() when the run began
    log: object = print
