"""The whole pipeline in one warm process against the north star
(port of ``scripts/pipeline_demo.py``):

    grids -> train (501 epochs) -> encode -> decode

through the port's CLI entry points (``nvfpcc_tpu_torch.cli.main``), each
stage timed on the host clock, then parity (``rc_enc == rc_dec``) and D1
and D2 PSNR against the source. The target is the project's: the whole
train + encode + decode in under 10 minutes (BASELINE.md). Prints one JSON
line of stage stats, the JAX script's keys in its order, and exits 1 when
parity fails. Everything runs on the card unless ``--platform cpu``.

    python -m nvfpcc_tpu_torch.tools.pipeline_demo [--cloud path.ply] [--epochs 501]
        [--entropy_mode channel|ctx|...] [--thh 0.65] [--out stats.json]

With no ``--cloud`` it writes the deterministic bumpy sphere of
``scripts/synth_cloud.py`` at radius 0.213 (about longdress's scale: 875,031
points in 964 blocks at depth 10).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

from nvfpcc_tpu_torch.cli import main as cli_main
from nvfpcc_tpu_torch.device import PLATFORMS, card_line, resolve_device
from nvfpcc_tpu_torch.io.ply import read_ply_points, write_ply_points
from nvfpcc_tpu_torch.metrics import d1_psnr, d2_psnr

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NORTH_STAR_S = 600.0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cloud", default=None)
    ap.add_argument("--epochs", type=int, default=501)
    ap.add_argument("--entropy_mode", default="channel")
    ap.add_argument("--ctx_detach_pred", action="store_true")
    ap.add_argument("--lambda", dest="lmbda", type=float, default=200.0)
    ap.add_argument("--thh", type=float, default=0.65)
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--out", default=None, help="write the stage stats JSON here")
    ap.add_argument("--platform", choices=PLATFORMS, default="default",
                    help="cpu: run on the host; default/device: run on the CUDA card")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    print(card_line(device), flush=True)
    work = args.workdir or tempfile.mkdtemp(prefix="nvfpcc_pipeline_")
    os.makedirs(work, exist_ok=True)
    stages: dict = {}
    t_all = time.perf_counter()

    cloud = args.cloud
    if cloud is None:
        sys.path.insert(0, ROOT)
        from scripts.synth_cloud import bumpy_sphere_cloud

        t0 = time.perf_counter()
        pts = bumpy_sphere_cloud(depth=args.depth, radius=0.213)
        cloud = os.path.join(work, "sphere_vox10.ply")
        write_ply_points(cloud, pts, ascii=False)
        stages["synth_cloud_s"] = round(time.perf_counter() - t0, 2)
        print(f"[pipeline] synthesized {len(pts)} pts -> {cloud}", flush=True)

    common = ["--depth", str(args.depth), "--level", str(args.level), "--platform", args.platform]

    def stage(name: str, argv: list) -> None:
        t0 = time.perf_counter()
        status = cli_main(argv)
        if status:
            raise SystemExit(f"stage {name} failed with {status}")
        stages[f"{name}_s"] = round(time.perf_counter() - t0, 2)
        print(f"[pipeline] {name}: {stages[f'{name}_s']} s", flush=True)

    ckpt = os.path.join(work, "ckpts")
    pack = os.path.join(work, "pack.pk")
    rc_enc = os.path.join(work, "rc_enc.ply")
    rc_dec = os.path.join(work, "rc_dec.ply")

    stage("grids", ["grids", cloud, *common])
    stage(
        "train",
        [
            "train", cloud, *common, "--epochs", str(args.epochs),
            "--lambda", str(args.lmbda), "--entropy_mode", args.entropy_mode,
            "--checkpoint_dir", ckpt,
            *(["--ctx_detach_pred"] if args.ctx_detach_pred else []),
        ],
    )
    stage(
        "encode",
        [
            "encode", cloud, *common, "--load_checkpoint", ckpt,
            "--entropy_mode", args.entropy_mode, "--pack_fn", pack,
            "--recon", rc_enc, "--thh", str(args.thh),
        ],
    )
    stage("decode", ["decode", pack, "--recon", rc_dec, "--platform", args.platform])

    stages["total_s"] = round(time.perf_counter() - t_all, 2)

    a, b = read_ply_points(rc_enc), read_ply_points(rc_dec)
    parity = a.shape == b.shape and bool(np.array_equal(a, b))
    stages["parity"] = parity
    stages["n_points_rec"] = int(len(b))
    if not len(b):
        raise SystemExit(f"the reconstruction at thh {args.thh} is empty; pass a lower --thh")

    src = np.rint(read_ply_points(cloud)).astype(np.int64)
    rec = np.rint(b).astype(np.int64)
    m = d1_psnr(src, rec, depth=args.depth, device=device)
    stages["d1_psnr"] = round(float(m["psnr"]), 4)
    m2 = d2_psnr(src, rec, depth=args.depth, device=device)
    stages["d2_psnr"] = round(float(m2["psnr"]), 4)
    stages["pack_bytes"] = os.path.getsize(pack)
    stages["bpp"] = round(8.0 * stages["pack_bytes"] / len(src), 4)
    stages["entropy_mode"] = args.entropy_mode
    stages["epochs"] = args.epochs
    stages["lambda"] = args.lmbda

    line = json.dumps(stages)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    if not parity:
        print("[pipeline] PARITY FAIL", file=sys.stderr)
        return 1
    under = stages["total_s"] < NORTH_STAR_S
    print(
        f"[pipeline] total {stages['total_s']} s — "
        f"{'UNDER' if under else 'over'} the 10-min north star", flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
