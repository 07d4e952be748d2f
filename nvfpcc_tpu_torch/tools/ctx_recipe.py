"""The path ``--entropy_mode auto`` takes at vox11 scale, on one CUDA card,
through the port's CLI on the synthetic vox11 sphere
(``scripts/synth_cloud.py --depth 11``) at ``--level 6``:

    grids -> graph = eager (``tools/graph_check.py``: ctx, the embedding
    update in the chunks ``train`` resolves for this block count, 2 epochs
    across the phase change, with CUDA graphs and eagerly under
    deterministic algorithms, equal bit for bit) -> train --entropy_mode
    auto (must resolve to ctx; CUDA graphs) -> encode
    --entropy_mode auto (must resolve to ctx_ar + ctx_post, hidden 32 tail
    24, with the default 3000 + 1000 fit steps and early stop) -> decode in a
    fresh process (rc_enc == rc_dec) -> eval (D1)

It times each stage on the host clock and writes the blocks, symbols, the
graph = eager pair (its result, the count of arrays compared, each side's
epoch seconds and peak device bytes, the seconds of each capture by q
phase), the train's capture seconds by q phase, fit seconds and the chunk
where each fit phase stopped, the pack's bytes and bpp split, the peak
device memory, the parity, and a profile of the fit's steps at this
cloud's shapes to ``--out``. A short
training does not reach the default threshold, so encode takes the
occupancy level that keeps about as many voxels as the cloud has points
(``threshold_keeping``), unless ``--thh`` is given.

    python -m nvfpcc_tpu_torch.tools.ctx_recipe --out .work/ctx_recipe.json
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def threshold_keeping(ckdir: str, n_points: int, device) -> float:
    """The occupancy level at which the latest checkpoint in ``ckdir``
    reconstructs about ``n_points`` voxels (quantized weights, rounded
    latents, as encode does), floored to 1e-4 and clipped to [0.01, 0.99]."""
    import torch

    from nvfpcc_tpu_torch import codec
    from nvfpcc_tpu_torch.codec import weights as W
    from nvfpcc_tpu_torch.config import ModelConfig
    from nvfpcc_tpu_torch.models import decoder as M
    from nvfpcc_tpu_torch.utils import checkpoint as C
    from nvfpcc_tpu_torch.utils.params import params_from_numpy

    params, emb, meta = C.load_checkpoint_meta(C.latest_checkpoint(ckdir))
    spec = codec.model_spec(ModelConfig(
        ch=meta["ch"], chanstr=meta["chanstr"], entropy_mode=meta["entropy_mode"],
        ctx_hidden=meta["ctx_hidden"], ctx_tail=meta["ctx_tail"]))
    qparams = W.quantize_residuals(params, 16)
    net = params_from_numpy(M.init_params(spec), qparams).to(device)
    with torch.no_grad():
        lat = M.get_latent_code(net, torch.as_tensor(emb, device=device))["quantized_latent"].cpu().numpy()
    occ = codec.reconstruct_all(codec.decoder_from_tree(spec, qparams, device), lat)
    flat = torch.from_numpy(occ.reshape(-1))
    thh = float(torch.kthvalue(flat, flat.numel() - n_points).values)
    return float(np.clip(np.floor(thh * 1e4) / 1e4, 0.01, 0.99))


def profile_fit(ckdir: str, device, steps: int = 250) -> dict:
    """Where a fit step's time goes at this cloud's shapes: ``steps`` q=0
    steps of the h32t24 ctx_ar fit on the checkpoint's latents, once plain
    (host clock) and once under ``torch.profiler`` (device time, device
    kernels and host launch calls, the kernels on top)."""
    from torch.profiler import ProfilerActivity, profile

    from nvfpcc_tpu_torch.models import decoder as M
    from nvfpcc_tpu_torch.tools.train_profile import kernel_table
    from nvfpcc_tpu_torch.train.ctx_fit import fit_ctx_predictor, latents_from_checkpoint
    from nvfpcc_tpu_torch.utils import checkpoint as C

    params, emb, meta = C.load_checkpoint_meta(C.latest_checkpoint(ckdir))
    spec = M.build_model_spec(meta["ch"], tuple(int(c) for c in meta["chanstr"].split(",")),
                              entropy_mode="ctx_ar", ctx_hidden=32, ctx_tail=24)
    lat = latents_from_checkpoint(spec, params, emb, device)

    def fit():
        fit_ctx_predictor(spec, lat, device, steps=steps, finetune_steps=0, early_stop=0.0, log=lambda m: None)

    fit()  # warm-up
    t = time.time()
    fit()
    wall = time.time() - t
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit()
    dev_us, kernels, top, calls = kernel_table(prof)
    return {"steps": steps, "wall_s": wall, "steps_per_s": steps / wall, "device_busy_s": dev_us / 1e6,
            "device_busy_share": dev_us / 1e6 / wall, "device_kernels_per_step": kernels / steps,
            "host_launch_calls_per_step": calls / steps, "top": top}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".work", "ctx_recipe"))
    ap.add_argument("--out", default=os.path.join(ROOT, ".work", "ctx_recipe.json"))
    ap.add_argument("--depth", type=int, default=11)
    ap.add_argument("--level", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--phase_change", type=int, default=6)
    ap.add_argument("--thh", type=float, default=None)
    args = ap.parse_args()
    # cuBLAS reads it at its first call; the graph = eager pair's
    # deterministic runs need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    if not torch.cuda.is_available():
        print("ctx_recipe needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from scripts.synth_cloud import bumpy_sphere_cloud

    from nvfpcc_tpu_torch.cli import main as cli
    from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
    from nvfpcc_tpu_torch.device import card_line
    from nvfpcc_tpu_torch.io.ply import read_ply_points, write_ply_points
    from nvfpcc_tpu_torch.tools.graph_check import graph_eager_pair, recorded
    from nvfpcc_tpu_torch.train.loop import resolve_emb_chunks

    def run(argv) -> tuple:
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            status = cli(argv)
        torch.cuda.synchronize()
        out = buf.getvalue()
        print(out, end="", flush=True)
        if status:
            raise RuntimeError(f"cli {argv[0]} returned {status}")
        return out, time.time() - t0

    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    w = lambda name: os.path.join(args.workdir, name)  # noqa: E731
    smi = card_line("cuda")
    report = {"card": smi, "torch": torch.__version__, "depth": args.depth, "level": args.level,
              "epochs": args.epochs, "phase_change": args.phase_change}
    t = time.time()
    pts = bumpy_sphere_cloud(args.depth, seed=0)
    write_ply_points(w("sphere.ply"), pts, ascii=False)
    report.update(n_points=len(pts), cloud_s=time.time() - t)
    common = [w("sphere.ply"), "--depth", str(args.depth), "--level", str(args.level)]

    torch.cuda.reset_peak_memory_stats()
    _, report["grids_s"] = run(["grids", *common])
    report["grids_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    with np.load(w(f"sphere_d{args.depth}_l{args.level}_grids.npz")) as art:
        report["blocks"] = int(len(art["origins"]))
        gt, dist = art["gt"], art["dist"]
    report["symbols"] = report["blocks"] * 3 * 8
    print(json.dumps({k: report[k] for k in ("n_points", "blocks", "symbols", "grids_s")}), flush=True)

    chunks = resolve_emb_chunks(0, report["blocks"])
    pair, _ = graph_eager_pair(gt, dist, ModelConfig(entropy_mode="ctx"),
                               TrainConfig(epochs=2, phase_change=1, eval_every=0, emb_chunks=chunks),
                               args.workdir, "graph_pair")
    del gt, dist
    report["graph_pair"] = {"entropy_mode": "ctx", "emb_chunks": chunks, **pair}
    print("graph = eager: " + json.dumps(report["graph_pair"]), flush=True)
    if not pair["equal"]:
        raise RuntimeError(f"graph-replayed training differs from eager: {pair['differ'][:8]}, "
                           f"metrics lines equal {pair['metric_lines_equal']}")
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    with recorded() as rec:
        out, report["train_s"] = run([
            "train", *common, "--entropy_mode", "auto", "--epochs", str(args.epochs),
            "--phase_change", str(args.phase_change), "--eval_every", str(max(args.epochs - 1, 1)),
            "--checkpoint_dir", w("ckpt"), "--metrics", w("train.jsonl"),
        ])
    report["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["train_capture_s"] = rec["capture_s"]
    del rec
    if "entropy_mode auto -> ctx" not in out:
        raise RuntimeError("train --entropy_mode auto did not resolve to ctx")
    report["epoch_s"] = [float(x) for x in re.findall(r" TRAIN ([\d.]+)s\]", out)]
    report["train_rows"] = [json.loads(line) for line in open(w("train.jsonl"))]

    thh = args.thh if args.thh is not None else threshold_keeping(w("ckpt"), len(pts), "cuda")
    torch.cuda.reset_peak_memory_stats()
    out, report["encode_s"] = run(["encode", *common, "--load_checkpoint", w("ckpt"), "--pack_fn", w("pack.pk"),
                                   "--recon", w("rc_enc.ply"), "--thh", str(thh)])
    report["encode_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if "ctx_ar + ctx_post (hidden 32 tail 24)" not in out:
        raise RuntimeError("encode --entropy_mode auto did not resolve to ctx_ar + ctx_post h32t24")
    m = re.search(r"-> (\d+) B pack \| bpp ([\d.]+) \(latent ([\d.]+) net ([\d.]+) origins ([\d.]+)\) "
                  r"\| recon (\d+) pts \| ctx payload (\d+) bits", out)
    fit = re.search(r"\[ctx_fit\] (\d+) steps in ([\d.]+)s \(([\d.]+) steps/s\)", out)
    report.update(
        thh=thh, pack_bytes=int(m[1]), bpp=float(m[2]), b_latent=float(m[3]), b_net=float(m[4]),
        b_origins=float(m[5]), n_points_rec=int(m[6]), ctx_payload_bits=int(m[7]),
        fit_steps=int(fit[1]), fit_s=float(fit[2]), fit_steps_per_s=float(fit[3]),
        fit_log=[ln for ln in out.splitlines() if ln.startswith("[ctx_fit]")],
        encode_line=[ln for ln in out.splitlines() if "entropy_mode auto ->" in ln][0],
    )

    t = time.time()
    dec = subprocess.run([sys.executable, "-m", "nvfpcc_tpu_torch.cli", "decode", w("pack.pk"),
                          "--recon", w("rc_dec.ply")], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    report["decode_fresh_process_s"] = time.time() - t
    print(dec.stdout, dec.stderr[-2000:] if dec.returncode else "", end="", flush=True)
    if dec.returncode:
        raise RuntimeError(f"decode exited {dec.returncode}")
    with open(w("rc_enc.ply"), "rb") as a, open(w("rc_dec.ply"), "rb") as b:
        report["parity"] = a.read() == b.read()
    torch.cuda.reset_peak_memory_stats()
    out, report["eval_s"] = run(["eval", w("sphere.ply"), w("rc_dec.ply"), "--depth", str(args.depth)])
    report["eval_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["d1_psnr"] = float(re.search(r"D1 PSNR ([\d.]+|inf)", out)[1])
    report["n_points_dec"] = len(read_ply_points(w("rc_dec.ply")))
    report["fit_profile"] = profile_fit(w("ckpt"), "cuda")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k not in ("train_rows", "fit_log")}), flush=True)
    shutil.rmtree(args.workdir, ignore_errors=True)
    if not report["parity"]:
        print("rc_enc != rc_dec", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
