"""On-card smoke test of the PyTorch port (``nvfpcc_tpu_torch``).

Builds the EDT kernel from ``nvfpcc_tpu_torch/csrc``, holds it against its
plain PyTorch version on the card (int16 and int32 lanes, empty and full
grids, single corner voxels), times it at the main path's shapes beside its
plain version and its bytes bound, then drives the serving path at the
flagship width (ch=3, chanstr 8,16,8,8, 32^3 blocks, channel entropy mode,
format-v4 pack) through the port's CLI on a synthetic vox10 cloud:

    grids --platform device -> encode (random seeded checkpoint) ->
    decode (in a second process) -> eval (D1)

plus a decode of the JAX-made ``tests/fixtures/packs/pack_v1.pk``.

Usage, from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--workdir DIR]

Any failure exits non-zero before the last line. On success the
second-to-last line is the kernel report (JSON) and the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the stand-in checkpoint (training is not ported yet): seeded init plus
# residuals in {-1, 0, 1}/16, embeddings ~ N(0, 2^2); at this threshold
# about 1.3% of the block voxels reconstruct as occupied
CKPT_SEED = 0
THH = "0.6"
EDT_CASES = [  # (shape, radius) held exactly against the plain version
    ((16, 16, 16), 5), ((24, 32, 40), 9), ((8, 8, 256), 20), ((64, 64, 64), 55),
    ((256, 256, 256), 55), ((200, 256, 136), 63),
    # int16 lanes at both ends, the generic radius, int32 lanes above R = 127
    ((40, 48, 56), 1), ((136, 144, 152), 127), ((96, 80, 72), 111), ((136, 144, 152), 128),
    ((200, 208, 216), 221),
]
# empty and full grids, and a single voxel in each corner: (kind, shape, radius)
EDT_SPECIAL = [("empty", (64, 72, 80), 55), ("full", (64, 72, 80), 63),
               ("corners", (72, 64, 136), 55), ("corners", (72, 64, 136), 128),
               ("empty", (40, 40, 40), 221)]
# timed shapes: the vox10 sphere's grids transform (reported in the kernel
# line) and one D1 direction of its eval; then R=27 at the first shape, to
# show how the time scales with the window
TIMED_EDT = [((688, 688, 688), 55), ((656, 656, 672), 63)]
R_SCALING = ((688, 688, 688), 27)
# the least time the card could take: the function reads 1 byte (occupancy)
# and writes 4 (int32) per voxel, over the H100's published 3.35 TB/s. Its
# operations (a lower-envelope EDT is O(1) integer work per voxel per axis)
# take less than that at the card's integer rate, so bytes bound it.
HBM_BYTES_PER_S = 3.35e12
EDT_BYTES_PER_VOXEL = 5


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def run_cli(argv) -> str:
    """Run one port CLI command in this process; echo and return its output.
    Exceptions and non-zero exits propagate."""
    from nvfpcc_tpu_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        status = main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    if status:
        fail(f"cli {argv[0]} returned {status}")
    return out


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def special_grids(kind: str, shape) -> list:
    if kind == "empty":
        return [np.zeros(shape, bool)]
    if kind == "full":
        return [np.ones(shape, bool)]
    grids = []
    for i in range(8):
        g = np.zeros(shape, bool)
        g[tuple(-1 if i >> a & 1 else 0 for a in range(3))] = True
        grids.append(g)
    return grids


def phase_kernel(torch, K) -> dict:
    """Build, then exact equality with the plain version, a brute-force spot
    check, and the timing at the main path's shapes."""
    t0 = time.time()
    lib = K.build_library()
    log(f"kernel build {time.time() - t0:.2f}s -> {os.path.relpath(lib, ROOT)}")
    with open(lib + ".log") as f:
        print(f.read(), end="")
    from nvfpcc_tpu_torch.grids.edt import brute_force_sq_dist

    max_err = 0
    for case, (shape, radius) in enumerate(EDT_CASES):
        for density in (0.01, 0.03):
            rng = np.random.default_rng(case)
            occ_np = rng.uniform(0, 1, shape) < density
            occ = torch.as_tensor(occ_np, device="cuda")
            got = K.squared_edt_3d(occ, radius)
            want = K.squared_edt_3d_ref(occ, radius)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            max_err = max(max_err, err)
            # brute-force spot check on sampled voxels
            vox = rng.integers(0, shape, (16, 3))
            bf = np.minimum(brute_force_sq_dist(vox, np.argwhere(occ_np)), radius * radius + 1)
            got_np = got.cpu().numpy()[vox[:, 0], vox[:, 1], vox[:, 2]]
            log(f"edt {shape} R={radius} ({K.lane_bits(radius)}-bit lanes) p={density}: "
                f"max|kernel-plain|={err}, brute-force probes equal={np.array_equal(got_np, bf)}")
            if err or not np.array_equal(got_np, bf):
                fail(f"EDT kernel disagrees at {shape} R={radius} p={density}")
    for kind, shape, radius in EDT_SPECIAL:
        for occ_np in special_grids(kind, shape):
            occ = torch.as_tensor(occ_np, device="cuda")
            err = int((K.squared_edt_3d(occ, radius) - K.squared_edt_3d_ref(occ, radius)).abs().max())
            max_err = max(max_err, err)
            if err:
                fail(f"EDT kernel disagrees on the {kind} grid {shape} R={radius}")
        log(f"edt {kind} {shape} R={radius}: equal to the plain version")
    timed = []
    for shape, radius in TIMED_EDT + [R_SCALING]:
        occ = torch.as_tensor(np.random.default_rng(7).uniform(0, 1, shape) < 0.003, device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = K.squared_edt_3d(occ, radius)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base + occ.numel()  # occ + out + scratch
        if not torch.equal(got, K.squared_edt_3d_ref(occ, radius)):
            fail(f"EDT kernel disagrees at {shape} R={radius}")
        del got
        ms = cuda_ms(lambda: K.squared_edt_3d(occ, radius), 10)
        plain_ms = cuda_ms(lambda: K.squared_edt_3d_ref(occ, radius), 2) if (shape, radius) != R_SCALING else None
        ms2 = cuda_ms(lambda: K.squared_edt_3d(occ, radius), 10)
        bound_ms = occ.numel() * EDT_BYTES_PER_VOXEL / HBM_BYTES_PER_S * 1e3
        row = {"shape": list(shape), "radius": radius, "lanes": K.lane_bits(radius),
               "ms": ms, "ms_again": ms2, "plain_ms": plain_ms,
               "plain_over_kernel": plain_ms / ms if plain_ms else None,
               "bound_ms": bound_ms, "share_of_bound": bound_ms / ms, "peak_bytes": peak}
        log(f"edt {shape} R={radius}: kernel {ms:.3f} / {ms2:.3f} ms, plain "
            f"{plain_ms if plain_ms is None else round(plain_ms, 3)} ms, bound {bound_ms:.3f} ms "
            f"({100 * bound_ms / ms:.1f}% of it), peak {peak / 1e9:.3f} GB")
        timed.append(row)
        del occ
        torch.cuda.empty_cache()
    log(f"edt 688^3: R=27 {timed[2]['ms']:.3f} ms vs R=55 {timed[0]['ms']:.3f} ms "
        f"(ratio {timed[2]['ms'] / timed[0]['ms']:.3f})")
    first = timed[0]
    return {"max_abs_err": max_err, "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes", "library_ms": None,
            "timed": timed}


def make_checkpoint(ckdir: str, n_blocks: int) -> None:
    from nvfpcc_tpu_torch.models import decoder as M
    from nvfpcc_tpu_torch.utils.checkpoint import save_checkpoint
    from nvfpcc_tpu_torch.utils.params import params_to_numpy

    spec = M.build_model_spec(3, (8, 16, 8, 8))
    tree = params_to_numpy(M.init_params(spec))
    rng = np.random.default_rng(CKPT_SEED)
    for name in M.TRANSMITTED_KERNELS:
        k = tree["decoder"][name]["kernel"]
        tree["decoder"][name]["kernel"] = (k + rng.integers(-1, 2, k.shape) / 16).astype(np.float32)
    emb = rng.normal(0, 2, (n_blocks, 2, 2, 2, 3)).astype(np.float32)
    meta = {"ch": 3, "chanstr": "8,16,8,8", "entropy_mode": "channel"}
    save_checkpoint(ckdir, 0, tree, emb, meta=meta)


def phase_fixture(torch) -> None:
    """The JAX-made v1 pack decodes on the card, equal to a reconstruction
    from its golden arrays; the card's occupancy matches the CPU's."""
    from nvfpcc_tpu_torch import codec
    from nvfpcc_tpu_torch.codec import weights as W
    from nvfpcc_tpu_torch.models import decoder as M

    fix = os.path.join(ROOT, "tests", "fixtures", "packs")
    pack = codec.load_pack(os.path.join(fix, "pack_v1.pk"))
    golden = np.load(os.path.join(fix, "golden_v1.npz"))
    points, info = codec.decode(pack, "cuda")
    spec = M.build_model_spec(2, (4, 8, 4, 4))
    tree = W.unpack_weights(pack["net_weight_pack"])
    for name in M.TRANSMITTED_KERNELS:
        if not np.array_equal(tree["decoder"][name]["kernel"], golden[f"kernel_{name}"]):
            fail(f"pack_v1 kernel {name} differs from its golden array")
    live = codec.reconstruct_points(
        codec.decoder_from_tree(spec, tree, "cuda"), golden["latents"].astype(np.float32),
        golden["origins"], float(pack["codec"]["thh"]),
    )
    occ_gpu = codec.reconstruct_all(codec.decoder_from_tree(spec, tree, "cuda"), golden["latents"])
    occ_cpu = codec.reconstruct_all(codec.decoder_from_tree(spec, tree, "cpu"), golden["latents"])
    diff = float(np.abs(occ_gpu - occ_cpu).max())
    log(f"pack_v1 (JAX-made): {info['n_blocks']} blocks -> {len(points)} pts, equal to the "
        f"golden reconstruction: {np.array_equal(points, live)}; occupancy |cuda-cpu| max {diff:.3g}")
    if not np.array_equal(points, live) or len(points) == 0:
        fail("pack_v1 decode differs from the golden reconstruction")
    if not (np.isfinite(occ_gpu).all() and diff < 1e-4):
        fail(f"card reconstruction is off the CPU's by {diff}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".work", "chip_smoke"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    from nvfpcc_tpu_torch.kernels import edt as K

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    print(smi, flush=True)

    # 2-3. kernel build and kernel vs plain
    kstats = phase_kernel(torch, K)

    # 4. the serving path at full width
    from scripts.synth_cloud import bumpy_sphere_cloud
    from nvfpcc_tpu_torch.cli import write_ply_points
    from nvfpcc_tpu_torch.grids.builder import validate_dist_grids

    shutil.rmtree(args.workdir, ignore_errors=True)
    os.makedirs(args.workdir)
    w = lambda name: os.path.join(args.workdir, name)  # noqa: E731
    secs = {}
    t = time.time()
    pts = bumpy_sphere_cloud(10, seed=0)
    write_ply_points(w("sphere.ply"), pts, ascii=False)
    secs["cloud"] = time.time() - t
    log(f"cloud: synthetic vox10 bumpy sphere, {len(pts)} points")

    K.LAUNCHES = 0
    t = time.time()
    run_cli(["grids", w("sphere.ply"), "--depth", "10", "--level", "5", "--platform", "device"])
    secs["grids"] = time.time() - t
    grids_launches = K.LAUNCHES
    with np.load(w("sphere_d10_l5_grids.npz")) as art:
        origins, dist = art["origins"], art["dist"]
    validate_dist_grids(pts, origins, dist, 32, seed=1)
    log(f"grids: {len(origins)} blocks, validate_dist_grids ok, EDT launches {grids_launches}")
    if grids_launches < 1:
        fail("grids did not launch the EDT kernel")

    make_checkpoint(w("ckpt"), len(origins))
    t = time.time()
    run_cli(["encode", w("sphere.ply"), "--depth", "10", "--level", "5",
             "--load_checkpoint", w("ckpt"), "--pack_fn", w("pack.pk"),
             "--recon", w("rc_enc.ply"), "--thh", THH, "--platform", "device"])
    secs["encode"] = time.time() - t
    log(f"encode: pack {os.path.getsize(w('pack.pk'))} bytes")

    t = time.time()
    dec = subprocess.run(
        [sys.executable, "-m", "nvfpcc_tpu_torch.cli", "decode", w("pack.pk"),
         "--recon", w("rc_dec.ply"), "--platform", "device"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    secs["decode"] = time.time() - t
    print(dec.stdout, end="")
    if dec.returncode:
        print(dec.stderr)
        fail(f"decode process exited {dec.returncode}")
    with open(w("rc_enc.ply"), "rb") as a, open(w("rc_dec.ply"), "rb") as b:
        enc_bytes, dec_bytes = a.read(), b.read()
    from nvfpcc_tpu_torch.cli import read_ply_points

    n_rec = len(read_ply_points(w("rc_dec.ply")))
    log(f"rc_enc.ply == rc_dec.ply bit-exact across processes: {enc_bytes == dec_bytes} "
        f"({n_rec} points)")
    if enc_bytes != dec_bytes or n_rec == 0:
        fail("encode/decode parity failed or the reconstruction is empty")

    # the same pack decoded again in this (warm) process: the stage time
    # without process start, CUDA init and the PLY write
    from nvfpcc_tpu_torch import codec

    pack = codec.load_pack(w("pack.pk"))
    codec.decode(pack, "cuda")
    torch.cuda.synchronize()
    t = time.time()
    warm_pts, _ = codec.decode(pack, "cuda")
    secs["decode_warm_in_process"] = time.time() - t
    if not np.array_equal(warm_pts, np.rint(read_ply_points(w("rc_enc.ply"))).astype(np.int64)):
        fail("in-process decode differs from rc_enc.ply")

    phase_fixture(torch)

    before = K.LAUNCHES
    t = time.time()
    out = run_cli(["eval", w("sphere.ply"), w("rc_dec.ply"), "--depth", "10", "--platform", "device"])
    secs["eval"] = time.time() - t
    eval_launches = K.LAUNCHES - before
    log(f"eval: EDT launches {eval_launches}")
    if eval_launches < 1 or "D1 PSNR" not in out:
        fail("eval did not run the EDT kernel")
    launches = K.LAUNCHES
    log("seconds per stage: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    shutil.rmtree(args.workdir, ignore_errors=True)

    print(json.dumps({"kernels": [{
        "name": "squared_edt_3d",
        "route": "cuda",
        "source": "nvfpcc_tpu_torch/csrc/edt.cu",
        "replaces": "nvfpcc_tpu/ops/pallas/edt_pallas.py:157",
        "launches": launches,
        "launches_by_stage": {"grids": grids_launches, "eval": eval_launches},
        **kstats,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
