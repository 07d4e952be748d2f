"""Run one cell of the benchmark once and print the contract's last line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run loads and warms up (``setup_s``), measures for ``--seconds``
seconds, checks what the timed path produced against the plain reference,
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, last, ``checks``:
each number compared with its limit, also printed as the last lines on
standard error. Without a CUDA card, or with fewer than the cell asks for,
it exits 1 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark.harness import ROOT, Context, Registry, banned_loaded, card_name, result_line  # noqa: E402

# build and kernel caches at fixed paths inside the checkout
CACHE = os.path.join(ROOT, ".bench_cache")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(reg: Registry, cell: dict, seed: int, seconds: float, trace: bool, device, config=None,
            t_start: float = T_START, info=None) -> tuple:
    """Run ``cell`` once on ``device``; returns (exit code, result line or
    None). ``config`` replaces the cell's configuration (tests run a small
    one on the CPU)."""
    if device.type == "cuda":
        import torch

        torch.cuda.set_device(device)
        torch.cuda.init()
    traffic = reg.traffic(cell["traffic"])
    limits = reg.limits(cell["name"])
    ctx = Context(cell, config or reg.config(cell["config"]), traffic, limits, seed, seconds, trace, device,
                  t_start, log=lambda s: print(s, file=sys.stderr, flush=True))
    out = reg.driver(traffic["driver"]).run(ctx)
    bad = banned_loaded()
    if bad:
        print(f"[bench] modules that may not be loaded are: {bad}", file=sys.stderr)
        return 3, None
    info = info or card_name(device)
    line = result_line(reg, cell["name"], out, limits, trace, info)
    print(json.dumps({"card": info.get("card"), "memory_peak_bytes": out.memory_peak_bytes}), flush=True)
    for name, c in line["checks"].items():
        print(f"[check] {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0, line


def main(argv=None) -> int:
    args = parse(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    reg = Registry()
    cell = reg.cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"[bench] {cell['name']} needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    return execute(reg, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))[0]


if __name__ == "__main__":
    sys.exit(main())
