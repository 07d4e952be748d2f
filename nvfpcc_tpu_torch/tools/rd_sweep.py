"""Rate-distortion sweep: train one model per lambda, then encode it and
score bpp against D1 PSNR at each decode threshold (port of
``scripts/rd_sweep.py``).

Per lambda it trains with the default recipe into ``<workdir>/l<lambda>``
with ``resume``, so a rerun picks up the latest train-state snapshot and a
finished run is not trained again (a snapshot is written every
``eval_every`` = 10 epochs, so the last epoch of the 501-epoch recipe has
one). Per threshold it encodes the trained state, scores D1 (and D2 unless
``--no_d2``) of the encoder's reconstruction, and appends one JSON line
to ``--out``, the JAX script's keys in its order; a summary table prints at
the end. Everything runs on the card unless ``--platform cpu``.

    python -m nvfpcc_tpu_torch.tools.rd_sweep cloud.ply --lambdas 100,200,400 \\
        --thhs 0.5,0.6,0.65,0.7 --epochs 501 --out rd.jsonl
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from nvfpcc_tpu_torch import codec
from nvfpcc_tpu_torch.cli import load_or_build_artifacts
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig, TrainConfig
from nvfpcc_tpu_torch.device import PLATFORMS, card_line, resolve_device
from nvfpcc_tpu_torch.io.ply import read_ply_points
from nvfpcc_tpu_torch.metrics import d1_psnr, d2_psnr
from nvfpcc_tpu_torch.train.loop import train
from nvfpcc_tpu_torch.utils.params import params_to_numpy


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cloud")
    ap.add_argument("--depth", type=int, default=10)
    ap.add_argument("--level", type=int, default=5)
    ap.add_argument("--lambdas", type=str, default="100,200,400")
    ap.add_argument("--thhs", type=str, default="0.5,0.6,0.65,0.7")
    ap.add_argument("--epochs", type=int, default=501)
    ap.add_argument("--workdir", type=str, default="/tmp/rd_sweep")
    ap.add_argument("--out", type=str, default="rd.jsonl")
    ap.add_argument("--d1_platform", choices=PLATFORMS, default=None,
                    help="device of the D1/D2 EDT (default: that of --platform)")
    ap.add_argument("--no_d2", action="store_true",
                    help="skip the point-to-plane (D2) metric")
    ap.add_argument("--platform", choices=PLATFORMS, default="default",
                    help="cpu: run on the host; default/device: run on the CUDA card")
    return ap


def encode_row(params: dict, emb: np.ndarray, art: dict, ref_pts: np.ndarray, model_cfg: ModelConfig,
               lmbda: float, thh: float, train_s: float, depth: int, level: int, device, d1_device,
               no_d2: bool):
    """(row, encode result) of one trained state at one threshold: the
    encoder's reconstruction scored against ``ref_pts``. An empty
    reconstruction raises ``SystemExit`` (its PSNR would mean nothing)."""
    n_points = int(art["gt"].sum())
    ccfg = CodecConfig(thh_encode=thh, thh_decode=thh, depth=depth, level=level)
    result = codec.encode(params, emb, art["origins"], model_cfg, ccfg, n_points, device)
    if len(result.points) == 0:
        raise SystemExit(f"[rd] lambda={lmbda:.0f} thh={thh:.2f}: the reconstruction is empty "
                         "(no occupancy above the threshold); pass lower --thhs")
    m = d1_psnr(ref_pts, result.points, depth, device=d1_device)
    m2 = None if no_d2 else d2_psnr(ref_pts, result.points, depth, device=d1_device)
    s = result.stats
    row = {
        "lambda": lmbda,
        "thh": thh,
        "bpp": s["bpp"],
        "b_latent": s["b_latent"],
        "b_net": s["b_net"],
        "b_origins": s["b_origins"],
        "d1_psnr": m["psnr"],
        "d1_mse": m["mse"],
        **({} if m2 is None else {"d2_psnr": m2["psnr"]}),
        "n_points_rec": s["n_points_rec"],
        "n_points_src": n_points,
        "train_s": round(train_s, 1),
    }
    return row, result


def sweep(cloud: str, lambdas, thhs, epochs: int, workdir: str, out: str, model_cfg: ModelConfig, device,
          d1_device=None, depth: int = 10, level: int = 5, no_d2: bool = False) -> list:
    """Train one model per lambda (resumable, in ``<workdir>/l<lambda>``),
    encode and score it at each threshold; append each row to ``out`` as it
    is made. Returns the rows."""
    device = torch.device(device)
    d1_device = device if d1_device is None else torch.device(d1_device)
    os.makedirs(workdir, exist_ok=True)
    art = load_or_build_artifacts(cloud, depth, level, device)
    ref_pts = np.rint(read_ply_points(cloud)).astype(np.int64)
    rows = []
    for lmbda in lambdas:
        tag = f"l{int(lmbda)}"
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        _, state = train(
            art["gt"], art["dist"], model_cfg, TrainConfig(lmbda=lmbda, epochs=epochs), device,
            checkpoint_dir=os.path.join(workdir, tag),
            log=lambda s: print(f"[{tag}] {s}", flush=True) if "TEST" in s else None,
            resume=True,
        )
        train_s = time.time() - t0
        params, emb = params_to_numpy(state.net), state.emb.detach().cpu().numpy()
        # free this lambda's model and both Adams before the next train
        del state
        if device.type == "cuda":
            torch.cuda.empty_cache()
            print(f"[{tag}] peak device memory of the train: "
                  f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB", flush=True)
        for thh in thhs:
            row, _ = encode_row(params, emb, art, ref_pts, model_cfg, lmbda, thh, train_s, depth, level,
                                device, d1_device, no_d2)
            rows.append(row)
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
            d2s = "" if no_d2 else f" D2={row['d2_psnr']:.2f}dB"
            print(
                f"[rd] lambda={lmbda:.0f} thh={thh:.2f} bpp={row['bpp']:.4f} "
                f"D1={row['d1_psnr']:.2f}dB{d2s} pts={row['n_points_rec']}", flush=True,
            )
    return rows


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    d1_device = None if args.d1_platform is None else resolve_device(args.d1_platform)
    print(card_line(device), flush=True)
    rows = sweep(
        args.cloud, [float(x) for x in args.lambdas.split(",")], [float(x) for x in args.thhs.split(",")],
        args.epochs, args.workdir, args.out, ModelConfig(), device, d1_device,
        args.depth, args.level, args.no_d2,
    )
    print("\nlambda  thh   bpp      D1(dB)   pts")
    for r in rows:
        print(
            f"{r['lambda']:6.0f} {r['thh']:5.2f} {r['bpp']:8.4f} "
            f"{r['d1_psnr']:8.2f} {r['n_points_rec']:9d}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
