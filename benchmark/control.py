"""The control and the planted faults of a cell, at the cell's own size:
what the numbers that decide ``correct`` read when the reference, in the
nearest precision below the configuration's, or with a fault planted, is
put in the program's place. Their smallest readings are the upper ends
the limits in ``benchmark/limits/`` are set under.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--epoch E] [--out FILE]

Training cells (configuration precision bf16): the control runs the conv
chain in float8 (e4m3 operands, e5m2 gradients); the fault ``half_batch``
leaves half of every batch and of the embedding update out and scales
the rest to the whole. Both are read on the first net steps from the
start and on a later epoch (``--epoch``, where the cell's run checks
one), step by step from the state the program reached there; the
program's own readings come out beside them (kind ``program``). Decode
cells (float32): the control rounds the
convs' operands to TF32; ``half_blocks`` reconstructs half of the blocks;
``moved_point`` moves one decoded point by one voxel. One JSON line per
seed and kind.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import numpy as np
import torch

from benchmark import generators
from benchmark.harness import Registry
from benchmark.reference import compare, train_ref


def _program_epoch(cfg: dict, gt, dist, seed: int, device, epoch: int) -> tuple:
    """(reference inputs, program side, batches) of epoch ``epoch`` of the
    program's run, recorded as a cell's run records it."""
    from benchmark.drivers import train as D

    T, program, state, args, noise, chunks = D._program(cfg, gt, dist, seed, device, graphs=device.type == "cuda")
    for e in range(epoch):
        T.run_epoch(*args, D.Q, noise, e, chunks, program=program)
    rec, prog = D.record_epoch(T, program, state, args, noise, chunks, epoch)
    n_batches = int(args[4].shape[0])
    del T, program, state, args
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec, prog, n_batches


def train_readings(cfg: dict, seed: int, device, steps: int = 3, epoch: int = 2) -> dict:
    """{kind: numbers} of the program, the fp8 control and the half-batch
    fault against the configuration's precision."""
    device = torch.device(device)
    gt, dist = generators.training_grids(seed, int(cfg["n_blocks"]), device)
    prec = cfg["train"]["compute_dtype"]
    rec, prog, n_batches = _program_epoch(cfg, gt, dist, seed, device, epoch)
    ref = train_ref.follow_steps(cfg, gt, dist, seed, steps, prec)
    at = ref["params"]
    ref["emb_grad"] = train_ref.full_set_emb_grad(cfg, at, gt, dist, seed, prec)
    ref_epoch = train_ref.epoch_steps(cfg, gt, dist, seed, epoch, rec, prec)
    out = {"program": compare.epoch_numbers(prog, ref_epoch, n_batches)}
    out["program"].pop("_worst")
    for kind, kw in (("control_fp8", {"precision": "fp8"}), ("half_batch", {"precision": prec, "half_batch": True})):
        side = train_ref.follow_steps(cfg, gt, dist, seed, steps, kw["precision"], kw.get("half_batch", False))
        side["emb_grad"] = train_ref.full_set_emb_grad(cfg, at, gt, dist, seed, kw["precision"],
                                                      half_batch=kw.get("half_batch", False))
        numbers = compare.train_numbers(side, ref)
        side = train_ref.epoch_steps(cfg, gt, dist, seed, epoch, rec, **kw)
        numbers.update(compare.epoch_numbers({**side, "steps": n_batches, "adam_steps": n_batches}, ref_epoch,
                                             n_batches))
        numbers.pop("_worst")
        out[kind] = numbers
    return out


def decode_readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """{kind: point_gap} of the TF32 control and the two decode faults, on
    the first frame the decode cell makes from ``seed``."""
    from benchmark.drivers.decode import frame, occupancy
    from benchmark.reference.nvfpcc import Model

    c = cfg["codec"]
    rng = np.random.default_rng(seed)
    model = Model(cfg, device)
    origins = generators.synthetic_origins(int(cfg["n_blocks"]), c["depth"], c["level"], int(rng.integers(1 << 62)))
    params, latents, thh = frame(cfg, traffic, model, rng, origins, device)
    ref = occupancy(model, params, latents, device).cpu().numpy()

    def points_of(occ):
        idx = np.argwhere(occ > np.float32(thh))
        return idx[:, 1:] + origins[idx[:, 0]]

    tf = occupancy(model, params, latents, device, precision="tf32").cpu().numpy()
    good = points_of(ref)
    half = points_of(ref[: len(ref) // 2])
    moved = good.copy()
    moved[0, 2] = moved[0, 2] + (1 if moved[0, 2] % 32 < 31 else -1)
    return {kind: compare.point_gap(pts, origins, ref, thh)[0]
            for kind, pts in (("control_tf32", points_of(tf)), ("half_blocks", half), ("moved_point", moved))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--epoch", type=int, default=2, help="training: the later epoch read step by step")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    reg = Registry()
    cell = reg.cell(args.workload)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        if traffic["driver"] == "train":
            readings = train_readings(cfg, seed, dev, epoch=args.epoch)
        else:
            readings = decode_readings(cfg, traffic, seed, dev)
        for kind, value in readings.items():
            line = json.dumps({"workload": cell["name"], "seed": seed, "kind": kind, "numbers": value})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
