"""The port's rate-distortion record on one CUDA card, on the cloud of the
JAX package's record (``results/rd_vox10_sphere.jsonl``): the bumpy sphere
of ``scripts/synth_cloud.py`` at radius 0.213, depth 10 (875,031 points,
964 blocks), at the flagship width.

    rd_sweep (--lambdas, --thhs, --epochs 501, --no_d2) -> with ``--score``,
    for the first lambda: encode_eval (with D2) at the threshold of its best
    D1 row, then ``cli encode --recon_dtype bf16`` of the same checkpoint at
    that threshold and the share of points that differ from the f32
    reconstruction

The sweep's rows go to ``<out stem>.jsonl``, the report (the card's name
and power limit, the rows, encode_eval's line, the flip share) to
``--out``. Rerunning into the same ``--workdir`` resumes each lambda from
its last snapshot.

    python -m nvfpcc_tpu_torch.tools.rd_record --lambdas 200 --score --out .work/rd_record.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lambdas", default="100,200,400")
    ap.add_argument("--thhs", default="0.5,0.6,0.65,0.7")
    ap.add_argument("--epochs", type=int, default=501)
    ap.add_argument("--score", action="store_true",
                    help="encode_eval (D2) and the bf16 flip share of the first lambda's checkpoint")
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".work", "rd_record"))
    ap.add_argument("--out", default=os.path.join(ROOT, ".work", "rd_record.json"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("rd_record needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from scripts.synth_cloud import bumpy_sphere_cloud

    from nvfpcc_tpu_torch.cli import main as cli
    from nvfpcc_tpu_torch.device import card_line
    from nvfpcc_tpu_torch.io.ply import read_ply_points, write_ply_points
    from nvfpcc_tpu_torch.tools import encode_eval, rd_sweep

    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    w = lambda name: os.path.join(args.workdir, name)  # noqa: E731
    cloud = w("sphere_r0213.ply")
    if not os.path.exists(cloud):
        write_ply_points(cloud, bumpy_sphere_cloud(10, radius=0.213), ascii=False)
    rows_path = os.path.splitext(args.out)[0] + ".jsonl"
    report = {"card": card_line("cuda"), "torch": torch.__version__, "epochs": args.epochs}
    t0 = time.time()
    if rd_sweep.main([cloud, "--lambdas", args.lambdas, "--thhs", args.thhs, "--epochs", str(args.epochs),
                      "--no_d2", "--workdir", w("sweep"), "--out", rows_path]):
        return 1
    report["sweep_s"] = time.time() - t0
    with open(rows_path) as f:
        report["rows"] = [json.loads(line) for line in f]
    if args.score:
        lmbda = float(args.lambdas.split(",")[0])
        best = max((r for r in report["rows"] if r["lambda"] == lmbda), key=lambda r: r["d1_psnr"])
        ckpt, thh = w(f"sweep/l{int(lmbda)}"), str(best["thh"])
        ee_out = w("encode_eval.json")
        if encode_eval.main([cloud, "--ckpt", ckpt, "--thh", thh, "--out", ee_out]):
            return 1
        with open(ee_out) as f:
            report["encode_eval"] = {"lambda": lmbda, "thh": best["thh"], **json.loads(f.read())}
        t1 = time.time()
        if cli(["encode", cloud, "--load_checkpoint", ckpt, "--pack_fn", w("pack_bf16.pk"),
                "--recon", w("rc_enc_bf16.ply"), "--thh", thh, "--recon_dtype", "bf16"]):
            return 1
        f32, bf16 = (set(map(tuple, np.rint(read_ply_points(p)).astype(np.int64)))
                     for p in (w("sweep/rc_enc.ply"), w("rc_enc_bf16.ply")))
        report["bf16"] = {"thh": best["thh"], "encode_s": time.time() - t1, "n_points_f32": len(f32),
                          "n_points_bf16": len(bf16), "flipped": len(f32 ^ bf16),
                          "flip_share": len(f32 ^ bf16) / max(len(f32), 1),
                          "pack_bytes": os.path.getsize(w("pack_bf16.pk"))}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "rows"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
