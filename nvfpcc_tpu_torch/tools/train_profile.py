"""Where a training epoch's time goes, on one CUDA card.

Builds (or loads) the grids of the synthetic vox10 sphere, or with
``--grids flagship`` takes the 917 synthetic blocks of ``tools/bench.py``,
and, at the flagship width (ch=3, chanstr 8,16,8,8, batch 16), measures for each
compute dtype and each cuDNN setting named below:

- seconds per epoch (host clock around an epoch that ends in a fetch), the
  median of ``--epochs`` epochs after one warm-up epoch, in each q phase;
- the split net steps / embedding update / eval with CUDA events;
- peak device memory of each part (``torch.cuda.max_memory_allocated``);
- with ``torch.profiler`` over one epoch: the device's busy share of the
  epoch's wall time and the kernels that take most of the device time, for
  the net steps and for the embedding update separately.

cuDNN settings compared, in turns within this one process:
``free`` (deterministic off, benchmark off), ``deterministic``
(deterministic on, benchmark off), ``benchmark`` (deterministic off,
benchmark on). TF32 is off throughout. Each cell runs both paths of the
trainer's epoch (``train.loop.EpochProgram``): ``graphs`` (the gradients
of the net step and of the embedding update replayed as CUDA graphs, each
followed by its Adam step, as ``train`` runs them on the card) and
``eager`` (the same steps launched kernel by kernel); for each,
the profiled q=2 parts also give the host's launch calls (kernel launches,
graph launches, copies and fills) and the kernels the device ran, per net
step.

    python -m nvfpcc_tpu_torch.tools.train_profile --out .work/train_profile.json
    python -m nvfpcc_tpu_torch.tools.train_profile --grids flagship --dtypes bf16 --cudnn free

One JSON line per measurement on stdout; the whole report goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CUDNN = {"free": (False, False), "deterministic": (True, False), "benchmark": (False, True)}


def sphere_grids(workdir: str, device):
    """gt, dist of the synthetic vox10 sphere at level 5, built on ``device``."""
    sys.path.insert(0, ROOT)
    from scripts.synth_cloud import bumpy_sphere_cloud

    from nvfpcc_tpu_torch.cli import load_or_build_artifacts
    from nvfpcc_tpu_torch.io.ply import write_ply_points

    os.makedirs(workdir, exist_ok=True)
    cloud = os.path.join(workdir, "sphere.ply")
    if not os.path.exists(cloud):
        write_ply_points(cloud, bumpy_sphere_cloud(10, seed=0), ascii=False)
    art = load_or_build_artifacts(cloud, 10, 5, device)
    return art["gt"], art["dist"]


def event_ms(fn) -> float:
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def peak_of(fn):
    """(result, peak bytes allocated while ``fn`` ran, above what was held before)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


# the CUDA API calls (cuda* and cu*) that put work on the device, as the
# profiler names them on the host side
LAUNCH_CALLS = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy|Memset)")


def kernel_table(prof, top: int = 8):
    """(device microseconds in all kernels and copies, their number, the
    ``top`` of them by device time, the host's launch calls) from the
    profiler's rows (the kernels a CUDA graph replays have rows of their own)."""
    from torch.autograd import DeviceType

    # "Optimizer.step#..." rows are the profiler's own annotation of a span
    # on the device timeline; they cover kernels that have rows of their own
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("Optimizer.step#")]
    if not rows:
        raise RuntimeError("torch.profiler recorded no device time")
    calls = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CPU and LAUNCH_CALLS.match(e.key))
    total = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return total, launches, [
        {"kernel": k[:90], "us": us, "calls": n, "share": us / total} for k, us, n in rows[:top]
    ], calls


class EpochRunner:
    """One training state at the flagship width and the pieces of its epoch,
    on one ``EpochProgram`` (with CUDA graphs or eager)."""

    def __init__(self, gt, dist, compute_dtype: str, device, graphs: bool = False):
        import torch

        from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
        from nvfpcc_tpu_torch.models import decoder as M
        from nvfpcc_tpu_torch.train import loop as T

        self.T, self.torch = T, torch
        self.cfg = TrainConfig(compute_dtype=compute_dtype)
        mcfg = ModelConfig()
        spec = M.build_model_spec(mcfg.ch, mcfg.channels, mcfg.seed_tag, "channel")
        self.n = int(gt.shape[0])
        self.n_pts = float(gt.sum())
        net = T.initial_params(spec, mcfg, device)
        emb = M.init_embeddings(self.n, mcfg.ch, device).requires_grad_(True)
        opt, emb_opt = T.make_optimizers(self.cfg, net, emb)
        self.state = T.TrainState(net, opt, emb, emb_opt)
        self.gt, self.dist = T._prep_dense(gt, dist, device)
        self.valid = torch.ones(self.n, device=device)
        self.noise = T.NoiseSource(0, spec, device)
        self.program = T.EpochProgram(self.state, self.cfg, self.gt, self.dist, self.valid, self.n_pts,
                                      self.noise, graphs=graphs)
        self.epoch = 0

    def plan(self):
        idx, mask = self.T.batch_plan(self.n, self.cfg.batch_size, "stride", 0, self.epoch)
        return self.torch.from_numpy(idx).long(), self.torch.from_numpy(mask)

    @property
    def n_batches(self) -> int:
        return -(-self.n // self.cfg.batch_size)

    def net_steps(self, q):
        idx, mask = self.plan()
        self.noise.start_epoch(self.epoch, idx.shape[0])
        self.program.net_steps(self.epoch, q, idx, mask)

    def emb_update(self, q):
        self.program.emb_update(self.epoch, q)

    def evaluate(self):
        return self.T.evaluate(self.state.net, self.cfg, self.state.emb, self.gt, self.dist,
                               self.valid, self.n_pts)

    def whole_epoch(self, q) -> float:
        """Host seconds of one epoch as ``train`` runs it (ends in the fetch)."""
        t0 = time.time()
        idx, mask = self.plan()
        rows = self.T.run_epoch(self.state, self.cfg, self.gt, self.dist, idx, mask, self.valid,
                                self.n_pts, q, self.noise, self.epoch, program=self.program)
        rows = rows.cpu().numpy()
        self.epoch += 1
        if not np.isfinite(rows).all():
            raise RuntimeError("non-finite metrics in the profiled epoch")
        return time.time() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".work", "train_profile"))
    ap.add_argument("--out", default=os.path.join(ROOT, ".work", "train_profile.json"))
    ap.add_argument("--epochs", type=int, default=3, help="timed epochs per cell, after one warm-up")
    ap.add_argument("--dtypes", default="bf16,f32")
    ap.add_argument("--cudnn", default="free,deterministic,benchmark")
    ap.add_argument("--grids", choices=("sphere", "flagship"), default="sphere",
                    help="flagship: tools/bench.py's 917 synthetic blocks instead of the vox10 sphere")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_profile needs a CUDA card", file=sys.stderr)
        return 1
    from nvfpcc_tpu_torch.device import card_line

    device = torch.device("cuda")
    smi = card_line(device)
    report = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda, "cells": []}
    print(json.dumps({"card": smi}), flush=True)
    if args.grids == "flagship":
        from nvfpcc_tpu_torch.tools.bench import synthetic_flagship_grids

        gt, dist = synthetic_flagship_grids()
    else:
        gt, dist = sphere_grids(args.workdir, device)
    report["grids"] = args.grids
    report["n_blocks"] = int(gt.shape[0])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    for cd in args.dtypes.split(","):
        for name in args.cudnn.split(","):
            for path in ("graphs", "eager"):
                torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = CUDNN[name]
                run = EpochRunner(gt, dist, cd, device, graphs={"graphs": True, "eager": False}[path])
                cell = {"compute_dtype": cd, "cudnn": name, "path": path}
                for q in (1, 2):
                    warm = run.whole_epoch(q)  # with graphs, it captures the phase's two
                    secs = [run.whole_epoch(q) for _ in range(args.epochs)]
                    _, net_peak = peak_of(lambda: run.net_steps(q))
                    net_ms = event_ms(lambda: run.net_steps(q))
                    _, emb_peak = peak_of(lambda: run.emb_update(q))
                    emb_ms = event_ms(lambda: run.emb_update(q))
                    cell[f"q{q}"] = {
                        "warmup_epoch_s": warm, "epoch_s": secs, "epoch_s_median": statistics.median(secs),
                        "net_steps_ms": net_ms, "emb_update_ms": emb_ms,
                        "net_steps_peak_bytes": net_peak, "emb_update_peak_bytes": emb_peak,
                    }
                _, eval_peak = peak_of(run.evaluate)
                cell["eval_ms"] = event_ms(run.evaluate)
                cell["eval_peak_bytes"] = eval_peak
                if name == args.cudnn.split(",")[0]:
                    # device busy share, launches and the kernels on top, q=2 (the long phase)
                    for part, fn in (("net_steps", lambda: run.net_steps(2)),
                                     ("emb_update", lambda: run.emb_update(2))):
                        torch.cuda.synchronize()
                        t0 = time.time()
                        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                            fn()
                            torch.cuda.synchronize()
                        wall = time.time() - t0
                        dev_us, launches, top, calls = kernel_table(prof)
                        plain_s = cell["q2"][f"{part}_ms"] / 1e3  # the same part, timed without the profiler
                        steps = run.n_batches if part == "net_steps" else 1
                        cell[f"profile_{part}"] = {
                            "wall_s_under_profiler": wall, "device_busy_s": dev_us / 1e6,
                            "device_busy_share": dev_us / 1e6 / plain_s, "device_launches": launches,
                            "host_launch_calls": calls, "steps": steps,
                            "device_kernels_per_step": launches / steps, "host_launch_calls_per_step": calls / steps,
                            "top_kernels": top,
                        }
                report["cells"].append(cell)
                print(json.dumps(cell), flush=True)
                del run
                torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
