"""On-card smoke test of the PyTorch port (``nvfpcc_tpu_torch``).

Builds the CUDA kernels from ``nvfpcc_tpu_torch/csrc``, holds the EDT against
its plain PyTorch version on the card (int16 and int32 lanes, empty and full
grids, single corner voxels), times it at the main path's shapes beside its
plain version and its bytes bound; holds the transposed conv kernel against
its plain version and deterministic cuDNN at each of the decoder's
transposed layers and the direct convs' input gradients it computes, and
times each at the main path's batches (128 in f32 for a reconstruction, 16
and 917 in bf16 for a net step and the embedding update) beside its FFMA or
bytes bound, its plain version and cuDNN (``library_ms``); holds the
direct conv kernel against its plain version and deterministic cuDNN at
every f32 direct layer of the port and times it at 128 and 1,024 blocks
beside its FFMA bound, its plain version, cuDNN and the transposed conv
kernel on the flipped weights (ptxas' report beside); then drives the README workflow at the
flagship width (ch=3, chanstr 8,16,8,8, 32^3 blocks, lambda 200, batch 16,
channel entropy mode, format-v4 pack) through the port's CLI on a synthetic
vox10 cloud (1,314 blocks):

    grids --platform device -> train (3 epochs of q=1 then 3 of q=2 in
    bf16, a resume for one more epoch, then 2 epochs in f32) -> encode (the
    checkpoint just trained) -> decode (in a second process) -> eval (D1)

plus a decode of the JAX-made ``tests/fixtures/packs/pack_v1.pk``. The train
phase fails unless every epoch's loss is finite, the loss falls within the
q=1 epochs, params and embeddings moved and are f32, the eval line printed,
a checkpoint and a snapshot exist and ``--resume`` runs one more epoch. It
prints seconds per epoch for each phase, the split net steps / embedding
update / eval (CUDA events) and the peak device memory.

Then CUDA graphs against eager on the sphere's grids at flagship width,
under ``torch.use_deterministic_algorithms`` (``tools/graph_check.py``):
``train`` with ``graphs=True`` (the gradients of the net step and of the
embedding update captured once a q phase and replayed, each followed by
its Adam step, as the trainer runs on the card) and with
``graphs=False`` (the same steps launched one kernel at a time) from the
same init, in bf16 for 2 epochs at q=1 and 2 at q=2 (eval every 2), for 2
epochs with the embedding update in 2 chunks, and for 2 epochs across the
phase change in each other entropy mode (ctx, whose q=2 step draws no
noise, spatio, gmm, factorized, ctx_ar), then channel in f32 for 2 epochs,
then channel in bf16 for 2 epochs into a checkpoint dir and resumed from
its snapshot to 4 (each side its own dir); every parameter, the
embeddings, both Adams' moments and steps, every metric row and the
metrics lines must be equal bit for bit. Then the ctx_post fit (ctx_ar,
hidden 32, tail 24) of the ctx run's latents with graphs and eager, one
250-step chunk a phase: the fitted trees equal bit for bit. It prints both
ways' epoch seconds and peak device bytes, the capture seconds of each q
phase, the fit's steps per second, and, with cuDNN free, the net steps' device
kernels and host launch calls per step and the device's busy share (10
steps on 160 of the blocks).

Then the README's workflow tools, as a user runs them, on that sphere, its
grids and the checkpoint just trained:

    encode_eval (--no_d2, the channel encode's threshold; its pack must be
    byte-equal to the channel encode's) -> rd_sweep --lambdas 200 --epochs 1
    --no_d2 at two thresholds that keep points (read off a 1-epoch probe),
    then again into the same workdir (it must train nothing and give the
    same rows; a row must equal encode_eval of the checkpoint the sweep
    trained) -> pipeline_demo --depth 9 --level 4 --epochs 4 on the sphere it
    synthesizes (parity, finite D1 and D2)

each with its exact EDT launch count (2, 4 + 4 + 2, grids 1 of the depth-9
probe, 5).

Then the context-model path (entropy modes ctx / ctx_ar) on the same grids:

    train --entropy_mode ctx --emb_chunks 2 (1 epoch at q=1, 1 at q=2, bf16)
    -> encode, auto (below the ctx_post break-even at vox10: a ctx pack with
    the co-trained predictor) and explicit ctx_ar --ctx_post --ctx_hidden 32
    --ctx_tail 24 (what auto picks at vox11) -> decode of each pack in a
    second process, byte-equal to the encoder's cloud -> eval (D1)

plus a decode of the JAX-made ctx pack ``pack_v3.pk`` against its golden
latents. It prints the ctx epoch seconds, the fit's seconds and steps per
second, and each pack's bpp split and ctx payload bits.

Then bf16 reconstruction: encode of the channel checkpoint with
``--recon_dtype bf16`` at the same threshold -> decode in a second process,
byte-equal -> eval (D1); it prints the share of points that differ from the
f32 reconstruction and the warm in-process decode of the f32 and the bf16
pack (median of 5, CUDA events). Then the other latent entropy modes:

    for spatio, gmm, factorized: train (1 epoch at q=1, 1 at q=2, bf16)
    -> encode; then one second process (``serve``) decodes the three packs,
    each byte-equal to its encoder's cloud -> eval (D1) of each

plus a decode of the JAX-made spatio pack ``pack_v2.pk`` against its golden
latents; it prints each mode's epoch seconds, bpp split and latent table
bits. Then ``eval --d2`` on the channel reconstruction: four EDT launches
(two for D1, two for D2) and the host seconds of the normals.

Then block-data-parallel training (``train --mesh``) at the flagship width
on the same grids, in f32 for 2 epochs (q=1, then q=2). First the runs
that are compared, under ``torch.use_deterministic_algorithms`` (cuDNN's
training algorithms are otherwise free, and two free plain runs part from
the second epoch on):

    plain train twice -> train --mesh through the CLI alone (world size 1,
    NCCL) -> two ranks on the one card over gloo through
    ``parallel.run_group`` (world size 2; NCCL refuses two ranks on one
    device) -> one net step over all blocks and the embedding update, plain
    and at world size 2, from the init (q=1) and from the first plain run's
    snapshot after epoch 0 (q=2, the embeddings' second Adam step); the
    same plain gradients summed from two half-batch calls in this process

The two plain runs must agree bit for bit at every checkpoint, world size
1 must equal them bit for bit (every param, the embeddings, the metrics),
and world size 2's loss, bpp, pacc and nacc of every epoch and step must
stay within max(10 x the plain runs' spread, the CPU suite's bound 2e-6 +
2e-4 x |plain value|). After one step from a common state, world size 2's
net gradient, read off the Adam moments, must lie within max(10 x
||the plain gradient summed from two half-batch calls - the one-call
plain gradient||, 2e-4 x ||gradient||) of plain's, parameter by parameter
(the half-batch sum is computed in this process); its embedding moments
within a relative L2 distance of 2e-4. World size 2's params and
embeddings along the 2-epoch run are reported against plain train, not
held: each of its calls holds half a batch, which changes cuDNN's sums
(the classifier heads' weight gradients by up to about 1e-3 relative), and
83 Adam steps an epoch carry such differences past the CPU bound. Then, with
cuDNN free, the three kinds of run are timed -> train --mesh in bf16 for 3
epochs -> encode of the world-size-2 checkpoint -> decode in a second
process -> eval (D1, 2 EDT launches). It prints seconds per epoch of each
timed run (the two-rank run shares one card: no speedup), the bytes
all-reduced per net step and the all-reduce's time per step (CUDA events).

Then the repo's two root entry points, ported: ``tools/entry.py`` (the eval
forward over 917 flagship blocks: shapes, finite values, its first 8
blocks against the CPU's forward, timed) and ``tools/bench.py
--timed_chunks 1`` as a user runs it (917 synthetic flagship blocks, 10
warm-up and 10 timed bf16 epochs, a chunk of 10 replayed as CUDA graphs
with one fetch, then a warm encode and decode; its first line is the
card's, its last has ``bench.py``'s keys in order with finite values and
``epochs_per_dispatch`` 10, and its parity line is there); no EDT launch
on either path.

Last, the real-data path on both 8i-format fixtures (``tests/fixtures/
ref_style_vox10.ply`` and ``ref_style_vox10_v2.ply``: ascii PLY, float
x/y/z + uchar colours; v2 has near-empty blocks and a one-voxel filament)
at the flagship width:

    grids -> train (the train phase's epochs) -> encode (a threshold read
    off the checkpoint) -> one ``serve`` process decodes both packs ->
    eval (D1)

each pack's decode byte-equal to its encoder's cloud and not empty, each
D1 finite, and each of the path's 6 EDT calls (grids 1, eval 2 a fixture)
held against the plain version on the same input; then the kernel is timed
on those inputs beside its plain version and bound.

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
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the train phase: epochs in each quantization phase (bf16), then one more
# after a resume, then a short f32 run
TRAIN_EPOCHS, PHASE_CHANGE, EVAL_EVERY, F32_EPOCHS = 6, 3, 5, 2
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
# block-DP: the f32 runs take MESH_EPOCHS epochs (the first at q=1). World
# size 2 is held within the larger of MESH_SPREAD_FACTOR x the spread between
# two plain runs and the CPU suite's bound for block-DP against one process
# (tests/test_torch_parallel.py). Then the bf16 mesh run's epochs and its
# phase change.
MESH_EPOCHS = 2
# the workflow tools' phase: rd_sweep's epochs (1: the trainer snapshots every
# 10 epochs from epoch 0, so the last epoch is resumable) and pipeline_demo's
RD_EPOCHS, PIPELINE_EPOCHS = 1, 4
MESH_BF16_EPOCHS, MESH_BF16_PHASE_CHANGE = 3, 2
# the 8i-format fixtures of the real-data path (tests/fixtures), trained for
# the train phase's epochs
REALDATA = (("v1", "ref_style_vox10.ply"), ("v2", "ref_style_vox10_v2.ply"))
# bench.py's last line, in its order
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "baseline_inferred", "epochs_per_dispatch", "encode_ms",
              "decode_ms"]
# the graphs phase: train with CUDA graphs and eager from one init, per run
# (entropy mode, emb_chunks, epochs, phase change, eval_every, compute
# dtype); then the ctx_post fit both ways, one 250-step chunk a phase
GRAPH_RUNS = (("channel", 1, 4, 2, 2, "bf16"), ("channel", 2, 2, 1, 0, "bf16"), ("ctx", 1, 2, 1, 0, "bf16"),
              ("spatio", 1, 2, 1, 0, "bf16"), ("gmm", 1, 2, 1, 0, "bf16"), ("factorized", 1, 2, 1, 0, "bf16"),
              ("ctx_ar", 1, 2, 1, 0, "bf16"), ("channel", 1, 2, 1, 0, "f32"))
# and a resumed pair (channel, bf16): (epochs of the first run, epochs after
# the resume, phase change, eval_every); each side resumes from the snapshot
# its own first run wrote
GRAPH_RESUME = (2, 4, 3, 1)
GRAPH_FIT = dict(steps=250, finetune_steps=250, early_stop=0.0)
# the launch profile's blocks: 10 net steps of 16 (a step's kernels and
# launches do not depend on how many blocks the epoch has; the profiler's
# bookkeeping grows with the events it records)
LAUNCH_PROFILE_BLOCKS = 160
# entry's forward on the card against the CPU's, (rtol, atol) for the
# occupancy, the net bits and the latent bit sum: f32 with TF32 off, other
# conv algorithms and summation orders than the CPU's
ENTRY_TOL = ((1e-4, 1e-5), (1e-5, 0.0), (1e-4, 0.0))
MESH_METRICS = ("loss", "bpp", "pacc", "nacc")
MESH_RTOL, MESH_ATOL, MESH_SPREAD_FACTOR = 2e-4, 2e-6, 10.0
ADAM_B1 = 0.9  # both Adams' (train.loop.make_optimizers)
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


def run_tool(main, argv) -> str:
    """Run a port entry point's ``main(argv)`` (the CLI's or a tool's) in
    this process; echo and return its output. Exceptions, ``SystemExit``
    included, propagate; a non-zero return fails."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        status = main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    if status:
        fail(f"{main.__module__} {' '.join(argv[:1])} returned {status}")
    return out


def run_cli(argv) -> str:
    """Run one port CLI command in this process (:func:`run_tool`)."""
    from nvfpcc_tpu_torch.cli import main

    return run_tool(main, argv)


def last_json(out: str) -> dict:
    """The last line of ``out`` that is a JSON object."""
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


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


# the transposed conv kernel at the main path's batches: recon 128 (f32),
# the net step 16 and the embedding update 917 (bf16). Transposed layers:
# (layer, input edge, Cin, Cout, padding, output_padding); direct convs whose
# input gradient the kernel computes: (layer, output edge, Cout, Cin, k,
# padding), the gradient being a stride-1 transposed conv of the output edge
CONV_T_LAYERS = (("up0", 2, 3, 8, 2, 1), ("conv0", 4, 8, 16, 2, 1), ("up1", 8, 16, 8, 0, 0),
                 ("up2", 16, 8, 8, 0, 0))
CONV_DGRAD_LAYERS = (("conv1.dgrad", 16, 8, 8, 4, 0), ("conv2.dgrad", 32, 8, 8, 4, 0),
                     ("conv2_cls.dgrad", 32, 1, 8, 3, 1))
CONV_BATCHES = (("f32", 128), ("bf16", 16), ("bf16", 917))
F32_FFMA_PER_S = 67e12
# the direct conv kernel: every f32 direct conv of the port, (layer, input
# edge, Cin, Cout, k, padding), at a recon batch and at a flagship decode's
# 8 batches in one call
CONV_DIRECT_LAYERS = (("conv1", 19, 8, 8, 4, 0), ("conv2", 35, 8, 8, 4, 0), ("conv2_cls", 32, 8, 1, 3, 1),
                      ("latent_gen", 2, 3, 3, 1, 0), ("ctx1", 2, 3, 32, 3, 1), ("ctx2", 2, 32, 6, 3, 1))
CONV_DIRECT_BATCHES = (128, 1024)


def phase_conv_kernel(torch, CT) -> dict:
    """The transposed conv kernel against its plain version and cuDNN
    (deterministic, TF32 off) at each layer, then timed at the main path's
    batches beside its bound (f32 FFMA operations or bytes, the larger),
    the plain version and ``library_ms``: deterministic cuDNN computing the
    same function (``F.conv_transpose3d``; for an input gradient
    ``aten.convolution_backward`` of the direct conv)."""
    import torch.nn.functional as F
    from nvfpcc_tpu_torch.device import set_numerics

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    set_numerics()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    cases = [(name, edge, cin, cout, 5, 2, pad, opad, False) for name, edge, cin, cout, pad, opad in CONV_T_LAYERS]
    cases += [(name, edge, cin, cout, k, 1, pad, 0, True) for name, edge, cin, cout, k, pad in CONV_DGRAD_LAYERS]
    for name, edge, cin, cout, k, stride, pad, opad, dgrad in cases:
        for dtype_name, n in CONV_BATCHES:
            dt = torch.float32 if dtype_name == "f32" else torch.bfloat16
            x = torch.randn((n, edge, edge, edge, cin), generator=gen, device="cuda").to(dt)
            w = (torch.randn((k, k, k, cin, cout), generator=gen, device="cuda") * 0.1).to(dt)
            kernel = lambda: CT.launch(x, w, None, stride, pad, opad)  # noqa: E731
            got = kernel()
            if dgrad:  # the direct conv (Cout -> Cin) whose input gradient this is
                conv_in = torch.empty((n, *got.shape[1:4], cout), dtype=dt, device="cuda").permute(0, 4, 1, 2, 3)
                wd = w.transpose(3, 4).permute(4, 3, 0, 1, 2)

                def library():
                    return torch.ops.aten.convolution_backward(
                        x.permute(0, 4, 1, 2, 3), conv_in, wd, None, [1] * 3, [pad] * 3, [1] * 3, False, [0] * 3,
                        1, [True, False, False])[0].permute(0, 2, 3, 4, 1)
            else:
                def library():
                    return F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), w.permute(3, 4, 0, 1, 2), None, stride,
                                              pad, opad).permute(0, 2, 3, 4, 1)
            want, plain = library(), CT.conv_transpose3d_ref(x[:8], w, None, stride, pad, opad)
            torch.cuda.synchronize()
            scale = float(want.float().abs().max())
            err = float((got.float() - want.float()).abs().max()) / scale
            err_plain = float((got[:8].float() - plain.float()).abs().max()) / scale
            bound = 2e-5 if dt == torch.float32 else 2.0**-7
            if err > bound or err_plain > bound:
                fail(f"conv kernel {name} {dtype_name} n={n}: {err:.3g} from cuDNN, {err_plain:.3g} from the plain "
                     f"version (bound {bound:.3g} of the largest output)")
            del want, plain
            macs = CT.useful_macs(tuple(x.shape[1:4]), cin, cout, k, stride, pad, opad) * n
            nbytes = (x.numel() + w.numel() + got.numel()) * x.element_size()
            ops_ms, bytes_ms = 2 * macs / F32_FFMA_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            reps = 20 if n < 900 else 5
            ms = cuda_ms(kernel, reps)
            row = {"layer": name, "dtype": dtype_name, "n": n, "ms": ms, "bound_ms": max(ops_ms, bytes_ms),
                   "bound_by": "ffma" if ops_ms >= bytes_ms else "bytes", "share_of_bound": max(ops_ms, bytes_ms) / ms,
                   "plain_ms": cuda_ms(lambda: CT.conv_transpose3d_ref(x, w, None, stride, pad, opad), 1),
                   "library_ms": cuda_ms(library, reps), "ms_again": cuda_ms(kernel, reps),
                   "err_vs_library": err, "err_vs_plain": err_plain}
            log(f"conv kernel {name} {dtype_name} n={n}: {ms:.4f} / {row['ms_again']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {100 * row['share_of_bound']:.1f}%), plain "
                f"{row['plain_ms']:.3f} ms, cuDNN {row['library_ms']:.4f} ms, err {err:.2e} / {err_plain:.2e}")
            rows.append(row)
            del x, w, got
            torch.cuda.empty_cache()
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic) = flags
    return {"timed": rows}


def ptxas_report(kernel: str) -> list:
    """ptxas' lines (registers, shared memory, spills) for each
    instantiation of ``kernel`` in the built library's log."""
    from nvfpcc_tpu_torch.kernels.build import library_path

    with open(library_path() + ".log") as f:
        lines = f.read().splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            out.append(" | ".join(x.split("ptxas info    : ")[-1] for x in lines[i:i + 4]))
    return out


def phase_direct_conv_kernel(torch, C3, CT, transposed_rows: list) -> dict:
    """The direct conv kernel against cuDNN (deterministic, TF32 off) and
    its plain version at every f32 direct layer of the port, then timed at
    a recon batch (128) and a flagship decode's 1,024 blocks beside its
    bound (f32 FFMA operations or bytes, the larger), the plain version,
    ``library_ms`` (cuDNN's ``aten.convolution``, the port's route before
    this kernel) and ``transposed_ms`` (the transposed conv kernel on the
    flipped weights, the same function). ``conv2`` at 128 blocks must take
    at most half the transposed kernel's time on its shape, conv2's input
    gradient at 128 blocks in f32 (``transposed_rows``, the transposed
    conv phase's rows)."""
    import torch.nn.functional as F
    from benchmark.counters import taps_1d
    from nvfpcc_tpu_torch.device import set_numerics

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    set_numerics()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, edge, cin, cout, k, pad in CONV_DIRECT_LAYERS:
        for n in CONV_DIRECT_BATCHES:
            x = torch.randn((n, edge, edge, edge, cin), generator=gen, device="cuda")
            w = torch.randn((k, k, k, cin, cout), generator=gen, device="cuda") * 0.1
            b = torch.randn((cout,), generator=gen, device="cuda")
            w_flip = w.flip(0, 1, 2).contiguous()
            kernel = lambda: C3.launch(x, w, b, 1, pad)  # noqa: E731
            library = lambda: F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), b, 1,  # noqa: E731
                                       pad).permute(0, 2, 3, 4, 1)
            transposed = lambda: CT.launch(x, w_flip, b, 1, k - 1 - pad, 0)  # noqa: E731
            got = kernel()
            want, plain, via_t = library(), C3.conv3d_ref(x[:8], w, b, 1, pad), transposed()
            torch.cuda.synchronize()
            scale = float(want.abs().max())
            err = float((got - want).abs().max()) / scale
            err_plain = float((got[:8] - plain).abs().max()) / scale
            err_t = float((via_t - want).abs().max()) / scale
            if max(err, err_plain, err_t) > 2e-5:
                fail(f"direct conv kernel {name} n={n}: {err:.3g} from cuDNN, {err_plain:.3g} from the plain "
                     f"version, the transposed kernel {err_t:.3g} from cuDNN (bound 2e-5 of the largest output)")
            del want, plain, via_t
            n_out, pairs = taps_1d("conv", edge, k, 1, pad, 0)
            macs = pairs**3 * cin * cout * n
            nbytes = 4 * (x.numel() + w.numel() + got.numel())
            ops_ms, bytes_ms = 2 * macs / F32_FFMA_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
            reps = 20 if n < 900 else 5
            ms = cuda_ms(kernel, reps)
            bound = max(ops_ms, bytes_ms)
            row = {"layer": name, "dtype": "f32", "n": n, "ms": ms, "bound_ms": bound,
                   "bound_by": "ffma" if ops_ms >= bytes_ms else "bytes", "share_of_bound": bound / ms,
                   "plain_ms": cuda_ms(lambda: C3.conv3d_ref(x, w, b, 1, pad), 1),
                   "library_ms": cuda_ms(library, max(2, reps // 4)), "transposed_ms": cuda_ms(transposed, reps),
                   "ms_again": cuda_ms(kernel, reps), "err_vs_library": err, "err_vs_plain": err_plain,
                   "plan": C3.plan((edge,) * 3, cin, cout, k, pad)._asdict()}
            log(f"direct conv kernel {name} f32 n={n}: {ms:.4f} / {row['ms_again']:.4f} ms, bound {bound:.4f} ms "
                f"({row['bound_by']}, {100 * row['share_of_bound']:.1f}%), plain {row['plain_ms']:.3f} ms, cuDNN "
                f"{row['library_ms']:.4f} ms, transposed kernel {row['transposed_ms']:.4f} ms, err {err:.2e} / "
                f"{err_plain:.2e}")
            rows.append(row)
            del x, w, w_flip, got
            torch.cuda.empty_cache()
    conv2 = next(r for r in rows if r["layer"] == "conv2" and r["n"] == 128)
    dgrad = next(r for r in transposed_rows if (r["layer"], r["dtype"], r["n"]) == ("conv2.dgrad", "f32", 128))
    conv2["dgrad_ms"] = dgrad["ms"]
    log(f"direct conv kernel conv2 f32 n=128: {conv2['ms']:.4f} ms, the transposed kernel {dgrad['ms']:.4f} ms on "
        f"conv2's shape (its input gradient), {conv2['transposed_ms']:.4f} ms on the flipped weights")
    if conv2["ms"] > 0.5 * dgrad["ms"]:
        fail(f"direct conv kernel conv2 f32 n=128: {conv2['ms']:.4f} ms, over half the transposed kernel's "
             f"{dgrad['ms']:.4f} ms on the same shape")
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic) = flags
    ptxas = ptxas_report("conv3d_kernel")
    log("direct conv kernel, ptxas: " + " || ".join(ptxas))
    return {"timed": rows, "ptxas": ptxas}


def train_rows(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def epoch_seconds(out: str) -> list:
    """Seconds of each epoch from the trainer's ``[Epoch NNNN TRAIN 1.2s]`` lines."""
    return [float(line.split("TRAIN ")[1].split("s]")[0]) for line in out.splitlines() if " TRAIN " in line]


def median_after_first(xs):
    xs = sorted(xs[1:] or xs)
    return xs[len(xs) // 2]


def phase_train(torch, w, n_blocks: int) -> dict:
    """Train through the CLI on the card in bf16 and f32, check the run,
    resume it, and time the parts of an epoch."""
    from nvfpcc_tpu_torch.models import decoder as M
    from nvfpcc_tpu_torch.tools.train_profile import EpochRunner, event_ms, peak_of
    from nvfpcc_tpu_torch.utils import checkpoint as C
    from nvfpcc_tpu_torch.utils.params import flatten_tree, params_to_numpy

    common = [w("sphere.ply"), "--depth", "10", "--level", "5", "--platform", "device"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run_cli(["train", *common, "--epochs", str(TRAIN_EPOCHS), "--phase_change", str(PHASE_CHANGE),
                   "--eval_every", str(EVAL_EVERY), "--checkpoint_dir", w("ckpt"),
                   "--metrics", w("train_bf16.jsonl")])
    peak = torch.cuda.max_memory_allocated()
    rows = train_rows(w("train_bf16.jsonl"))
    if [(r["epoch"], r["q"]) for r in rows] != [(e, 1 if e < PHASE_CHANGE else 2) for e in range(TRAIN_EPOCHS)]:
        fail(f"train wrote unexpected epochs: {[(r['epoch'], r['q']) for r in rows]}")
    if not all(np.isfinite(r["loss"]) for r in rows):
        fail("a train epoch's loss is not finite")
    q1 = [r["loss"] for r in rows if r["q"] == 1]
    log(f"train bf16: loss per epoch {[round(r['loss'], 1) for r in rows]}")
    if not q1[-1] < q1[0]:
        fail(f"the loss did not fall within the q=1 epochs: {q1}")
    if out.count("TEST]") != 2:
        fail("the trainer's eval lines are missing")
    last = f"{TRAIN_EPOCHS - 1:04d}"
    for name in (f"{last}.npz", f"state_{last}.npz"):
        if not os.path.exists(os.path.join(w("ckpt"), name)):
            fail(f"train did not write {name}")
    params, emb, meta = C.load_checkpoint_meta(os.path.join(w("ckpt"), f"{last}.npz"))
    init = flatten_tree(params_to_numpy(M.init_params(M.build_model_spec(3, (8, 16, 8, 8)))))
    moved = {k: float(np.abs(v - init[k]).max()) for k, v in flatten_tree(params).items()}
    if emb.shape != (n_blocks, 2, 2, 2, 3) or emb.dtype != np.float32 or not np.abs(emb - 1).max() > 0:
        fail("embeddings did not move, or are not f32 of the expected shape")
    # the weight-rate mean has an exactly zero gradient while every residual
    # still rounds to 0, so it may stand still in the first epochs
    still = [k for k, v in moved.items() if v <= 0]
    if any(v.dtype != np.float32 for v in flatten_tree(params).values()) or set(still) - {"decoder/wrate/mu"}:
        fail(f"a parameter did not move or is not f32: {moved}")
    log(f"train bf16: {len(moved) - len(still)} of {len(moved)} parameter tensors moved (still: {still}; "
        f"largest move {max(moved.values()):.2e}), embeddings moved by {np.abs(emb - 1).max():.3f}, "
        f"all f32; checkpoint meta {meta}")
    bf16_secs = epoch_seconds(out)

    out = run_cli(["train", *common, "--epochs", str(TRAIN_EPOCHS + 1), "--phase_change", str(PHASE_CHANGE),
                   "--eval_every", str(EVAL_EVERY), "--checkpoint_dir", w("ckpt"), "--resume",
                   "--metrics", w("train_bf16.jsonl")])
    rows = train_rows(w("train_bf16.jsonl"))
    if "resumed from" not in out or out.count(" TRAIN ") != 1 or rows[-1]["epoch"] != TRAIN_EPOCHS:
        fail("--resume did not run exactly one more epoch from the snapshot")
    if not np.isfinite(rows[-1]["loss"]):
        fail("the resumed epoch's loss is not finite")
    log(f"train bf16: resumed from the snapshot of epoch {TRAIN_EPOCHS - 1}, epoch {TRAIN_EPOCHS} "
        f"loss {rows[-1]['loss']:.1f}")

    out = run_cli(["train", *common, "--epochs", str(F32_EPOCHS), "--phase_change", "1", "--eval_every", "0",
                   "--compute_dtype", "f32", "--checkpoint_dir", w("ckpt_f32"),
                   "--metrics", w("train_f32.jsonl")])
    rows32 = train_rows(w("train_f32.jsonl"))
    if len(rows32) != F32_EPOCHS or not all(np.isfinite(r["loss"]) for r in rows32):
        fail("the f32 train run did not finish with finite losses")
    f32_secs = epoch_seconds(out)
    log(f"train f32: loss per epoch {[round(r['loss'], 1) for r in rows32]}")
    peak = max(peak, torch.cuda.max_memory_allocated())

    # seconds per epoch as the trainer logged them (0.1 s steps), then the
    # parts of one epoch with CUDA events, on a fresh state of the same size
    log(f"seconds per epoch (trainer's log, median after the first): bf16 q=1 "
        f"{median_after_first(bf16_secs[:PHASE_CHANGE])}, bf16 q=2 {median_after_first(bf16_secs[PHASE_CHANGE:])}, "
        f"f32 {median_after_first(f32_secs)}; all epochs bf16 {bf16_secs} f32 {f32_secs}")
    with np.load(w("sphere_d10_l5_grids.npz")) as art:
        gt, dist = art["gt"], art["dist"]
    split = {}
    for cd, phases in (("bf16", (1, 2)), ("f32", (2,))):
        run = EpochRunner(gt, dist, cd, torch.device("cuda"))
        for q in phases:
            run.whole_epoch(q)
            net_ms = event_ms(lambda: run.net_steps(q))
            _, emb_peak = peak_of(lambda: run.emb_update(q))
            emb_ms = event_ms(lambda: run.emb_update(q))
            split[f"{cd}_q{q}"] = {"net_steps_ms": net_ms, "emb_update_ms": emb_ms,
                                   "emb_update_peak_gb": emb_peak / 1e9}
            log(f"epoch split {cd} q={q}: net steps {net_ms:.0f} ms, embedding update {emb_ms:.0f} ms "
                f"(peak {emb_peak / 1e9:.2f} GB above the resident state)")
        eval_ms = event_ms(run.evaluate)
        split[f"{cd}_eval_ms"] = eval_ms
        log(f"epoch split {cd}: eval {eval_ms:.0f} ms")
        del run
        torch.cuda.empty_cache()
    log(f"peak device memory of the train runs: {peak / 1e9:.2f} GB")
    return {"epoch_s_bf16": bf16_secs, "epoch_s_f32": f32_secs, "split": split, "peak_bytes": peak}


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


def encode_numbers(out: str) -> dict:
    """bpp split, pack size and ctx payload or latent table bits from an
    ``[encode]`` line."""
    m = re.search(r"-> (\d+) B pack \| bpp ([\d.]+) \(latent ([\d.]+) net ([\d.]+) origins ([\d.]+)\) "
                  r"\| recon (\d+) pts \| (ctx payload|latent tables) (\d+) bits", out)
    if m is None:
        fail("no [encode] summary line")
    return {"pack_bytes": int(m[1]), "bpp": float(m[2]), "b_latent": float(m[3]), "b_net": float(m[4]),
            "b_origins": float(m[5]), "n_points_rec": int(m[6]),
            "ctx_payload_bits": int(m[8]) if m[7] == "ctx payload" else None,
            "latent_table_bits": int(m[8]) if m[7] == "latent tables" else None}


def decode_in_second_process(pack: str, rc_dec: str) -> float:
    t = time.time()
    dec = subprocess.run(
        [sys.executable, "-m", "nvfpcc_tpu_torch.cli", "decode", pack, "--recon", rc_dec,
         "--platform", "device"],
        cwd=ROOT, capture_output=True, text=True, timeout=900,
    )
    secs = time.time() - t
    print(dec.stdout, end="")
    if dec.returncode:
        print(dec.stderr)
        fail(f"decode process exited {dec.returncode}")
    return secs


def run_eval(K, ref: str, rec: str, *flags) -> dict:
    """``eval`` on the card: seconds, EDT launches and the PSNR lines."""
    before = K.LAUNCHES
    t = time.time()
    out = run_cli(["eval", ref, rec, "--depth", "10", "--platform", "device", *flags])
    row = {"eval_s": time.time() - t, "launches": K.LAUNCHES - before}
    for name in ("D1", "D2"):
        m = re.search(name + r" PSNR ([\d.]+|inf)", out)
        if m:
            row[f"{name.lower()}_psnr"] = float(m[1])
    m = re.search(r"D2 seconds: normals ([\d.]+), nearest-neighbour vectors ([\d.]+) \(EDT ([\d.]+)\)", out)
    if m:
        row.update(normals_s=float(m[1]), nn_s=float(m[2]), edt_s=float(m[3]))
    if row["launches"] < 1 or "d1_psnr" not in row:
        fail(f"eval of {rec} did not run the EDT kernel or print D1")
    return row


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def point_set(path: str) -> set:
    from nvfpcc_tpu_torch.cli import read_ply_points

    return set(map(tuple, np.rint(read_ply_points(path)).astype(np.int64)))


def phase_ctx(torch, K, w, n_points: int, n_blocks: int) -> dict:
    """The ctx family on the card: ctx training, then both encodes, each
    pack decoded in a second process with ``rc_enc == rc_dec``, then eval.
    Returns the path's numbers, with its EDT launches."""
    from nvfpcc_tpu_torch.cli import read_ply_points
    from nvfpcc_tpu_torch.tools.ctx_recipe import threshold_keeping
    from nvfpcc_tpu_torch.utils import checkpoint as C

    common = [w("sphere.ply"), "--depth", "10", "--level", "5", "--platform", "device"]
    stats = {}
    t = time.time()
    torch.cuda.reset_peak_memory_stats()
    out = run_cli(["train", *common, "--entropy_mode", "ctx", "--emb_chunks", "2", "--epochs", "2",
                   "--phase_change", "1", "--eval_every", "1", "--checkpoint_dir", w("ckpt_ctx"),
                   "--metrics", w("train_ctx.jsonl")])
    stats["train_s"] = time.time() - t
    stats["train_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rows = train_rows(w("train_ctx.jsonl"))
    if [(r["epoch"], r["q"]) for r in rows] != [(0, 1), (1, 2)] or not all(np.isfinite(r["loss"]) for r in rows):
        fail(f"ctx train rows: {rows}")
    stats["epoch_s"] = epoch_seconds(out)
    params, emb, meta = C.load_checkpoint_meta(os.path.join(w("ckpt_ctx"), "0001.npz"))
    if meta["entropy_mode"] != "ctx" or emb.shape != (n_blocks, 2, 2, 2, 3):
        fail(f"ctx checkpoint meta {meta}, embeddings {emb.shape}")
    moved = {n: float(np.abs(params["entropy"][n]["kernel"]).max()) for n in ("ctx1", "ctx2")}
    if not all(v > 0 for v in moved.values()):
        fail(f"the ctx predictor did not train: {moved}")
    log(f"ctx train: epochs {stats['epoch_s']} s (q=1, q=2; bf16, embedding update in 2 chunks), "
        f"losses {[round(r['loss'], 1) for r in rows]}, b_latent {[round(r['b_latent'], 4) for r in rows]}, "
        f"largest ctx residual {moved}, peak {stats['train_peak_gb']:.2f} GB")

    thh = threshold_keeping(w("ckpt_ctx"), n_points, "cuda")
    packs = {
        "auto": [],
        "ctx_post": ["--entropy_mode", "ctx_ar", "--ctx_post", "--ctx_hidden", "32", "--ctx_tail", "24",
                     "--ctx_fit_steps", "500"],
    }
    for name, flags in packs.items():
        pack, enc, dec = w(f"pack_{name}.pk"), w(f"rc_enc_{name}.ply"), w(f"rc_dec_{name}.ply")
        t = time.time()
        out = run_cli(["encode", *common, "--load_checkpoint", w("ckpt_ctx"), "--pack_fn", pack, "--recon", enc,
                       "--thh", str(thh), *flags])
        row = {"thh": thh, "encode_s": time.time() - t, **encode_numbers(out)}
        if name == "auto" and "auto -> ctx (from checkpoint; ctx_post break-even not met" not in out:
            fail("encode auto on the vox10 ctx checkpoint did not keep the plain ctx pack")
        if name == "ctx_post":
            fit = re.search(r"\[ctx_fit\] (\d+) steps in ([\d.]+)s \(([\d.]+) steps/s\)", out)
            if fit is None:
                fail("the ctx_post fit did not report its steps")
            row.update(fit_steps=int(fit[1]), fit_s=float(fit[2]), fit_steps_per_s=float(fit[3]),
                       fit_log=[ln for ln in out.splitlines() if ln.startswith("[ctx_fit]")])
        row["decode_s"] = decode_in_second_process(pack, dec)
        row["parity"] = same_bytes(enc, dec)
        n_rec = len(read_ply_points(dec))
        log(f"ctx {name}: " + json.dumps({k: v for k, v in row.items() if k != "fit_log"}))
        if not row["parity"] or n_rec == 0 or row["ctx_payload_bits"] is None:
            fail(f"ctx {name}: rc_enc != rc_dec across processes, an empty cloud, or no ctx payload")
        stats[name] = row

    stats["eval"] = run_eval(K, w("sphere.ply"), w("rc_dec_ctx_post.ply"))
    log(f"ctx eval: D1 {stats['eval']['d1_psnr']} dB, EDT launches {stats['eval']['launches']}")
    return stats


def phase_mode_fixture(version: int, mode: str) -> None:
    """A JAX-made pack of another latent mode (``pack_v3.pk``: ctx;
    ``pack_v2.pk``: spatio with Huffman weights) decodes on the card:
    latents equal to its golden ints, points equal to a reconstruction from
    the golden arrays."""
    from nvfpcc_tpu_torch import codec
    from nvfpcc_tpu_torch.codec import weights as W
    from nvfpcc_tpu_torch.config import ModelConfig

    fix = os.path.join(ROOT, "tests", "fixtures", "packs")
    pack = codec.load_pack(os.path.join(fix, f"pack_v{version}.pk"))
    golden = np.load(os.path.join(fix, f"golden_v{version}.npz"))
    spec = codec.model_spec(ModelConfig(ch=2, chanstr="4,8,4,4", entropy_mode=mode))
    lat = codec.decode_latent_pack(spec, pack["latent_pack"])
    points, info = codec.decode(pack, "cuda")
    live = codec.reconstruct_points(
        codec.decoder_from_tree(spec, W.unpack_weights(pack["net_weight_pack"]), "cuda"),
        golden["latents"].astype(np.float32), golden["origins"], float(pack["codec"]["thh"]))
    ok = np.array_equal(lat, golden["latents"]) and np.array_equal(points, live) and len(points) > 0
    log(f"pack_v{version} (JAX-made {mode}): {info['n_blocks']} blocks -> {len(points)} pts, latents equal "
        f"to the golden ints and points to the golden reconstruction: {ok}")
    if not ok:
        fail(f"pack_v{version} decode differs from its golden arrays")


def warm_decode_ms(torch, packs: dict, reps: int = 5) -> dict:
    """Median ms of an in-process decode of each pack (CUDA events around the
    whole call, which ends in a host fetch), the packs taken in turns."""
    from nvfpcc_tpu_torch import codec

    loaded = {k: codec.load_pack(p) for k, p in packs.items()}
    for pack in loaded.values():
        codec.decode(pack, "cuda")
    times = {k: [] for k in loaded}
    for _ in range(reps):
        for k, pack in loaded.items():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            codec.decode(pack, "cuda")
            e1.record()
            torch.cuda.synchronize()
            times[k].append(e0.elapsed_time(e1))
    return {k: {"median_ms": float(np.median(v)), "all_ms": v} for k, v in times.items()}


def phase_bf16(torch, K, w, thh: float) -> dict:
    """The channel checkpoint encoded with ``--recon_dtype bf16`` at the
    f32 pack's threshold, decoded in a second process, compared with the
    f32 reconstruction, timed warm against the f32 pack, and scored."""
    common = [w("sphere.ply"), "--depth", "10", "--level", "5", "--platform", "device"]
    t = time.time()
    out = run_cli(["encode", *common, "--load_checkpoint", w("ckpt"), "--pack_fn", w("pack_bf16.pk"),
                   "--recon", w("rc_enc_bf16.ply"), "--thh", str(thh), "--recon_dtype", "bf16"])
    stats = {"thh": thh, "encode_s": time.time() - t, **encode_numbers(out)}
    stats["decode_s"] = decode_in_second_process(w("pack_bf16.pk"), w("rc_dec_bf16.ply"))
    stats["parity"] = same_bytes(w("rc_enc_bf16.ply"), w("rc_dec_bf16.ply"))
    f32_pts, bf16_pts = point_set(w("rc_enc.ply")), point_set(w("rc_enc_bf16.ply"))
    stats.update(n_points_f32=len(f32_pts), n_points_bf16=len(bf16_pts),
                 flipped=len(f32_pts ^ bf16_pts), flip_share=len(f32_pts ^ bf16_pts) / max(len(f32_pts), 1))
    if not stats["parity"] or not bf16_pts:
        fail("bf16 pack: rc_enc != rc_dec across processes, or an empty cloud")
    from nvfpcc_tpu_torch import codec

    if codec.load_pack(w("pack_bf16.pk"))["codec"].get("recon_dtype") != "bf16":
        fail("the bf16 pack does not carry codec.recon_dtype bf16")
    stats["warm_decode"] = warm_decode_ms(torch, {"f32": w("pack.pk"), "bf16": w("pack_bf16.pk")})
    stats["eval"] = run_eval(K, w("sphere.ply"), w("rc_dec_bf16.ply"))
    log("bf16 recon: " + json.dumps(stats))
    return stats


MODES = ("spatio", "gmm", "factorized")


def phase_modes(torch, K, w, n_points: int, n_blocks: int) -> dict:
    """spatio, gmm and factorized: train, encode, decode all three packs in
    one second process (the warm server), eval each reconstruction."""
    from nvfpcc_tpu_torch.tools.ctx_recipe import threshold_keeping
    from nvfpcc_tpu_torch.utils import checkpoint as C

    common = [w("sphere.ply"), "--depth", "10", "--level", "5", "--platform", "device"]
    stats = {}
    for mode in MODES:
        ck = w(f"ckpt_{mode}")
        t = time.time()
        out = run_cli(["train", *common, "--entropy_mode", mode, "--epochs", "2", "--phase_change", "1",
                       "--eval_every", "1", "--checkpoint_dir", ck, "--metrics", w(f"train_{mode}.jsonl")])
        row = {"train_s": time.time() - t, "epoch_s": epoch_seconds(out)}
        rows = train_rows(w(f"train_{mode}.jsonl"))
        if [(r["epoch"], r["q"]) for r in rows] != [(0, 1), (1, 2)] or not all(np.isfinite(r["loss"]) for r in rows):
            fail(f"{mode} train rows: {rows}")
        row["loss"] = [r["loss"] for r in rows]
        row["b_latent_train"] = [r["b_latent"] for r in rows]
        params, emb, meta = C.load_checkpoint_meta(os.path.join(ck, "0001.npz"))
        if meta["entropy_mode"] != mode or emb.shape != (n_blocks, 2, 2, 2, 3):
            fail(f"{mode} checkpoint meta {meta}, embeddings {emb.shape}")
        row["thh"] = threshold_keeping(ck, n_points, "cuda")
        t = time.time()
        out = run_cli(["encode", *common, "--load_checkpoint", ck, "--pack_fn", w(f"pack_{mode}.pk"),
                       "--recon", w(f"rc_enc_{mode}.ply"), "--thh", str(row["thh"])])
        row.update(encode_s=time.time() - t, **encode_numbers(out))
        if not row["latent_table_bits"]:
            fail(f"{mode} encode reported no latent table bits")
        stats[mode] = row

    # one second process decodes the three packs: `import torch` once
    reqs = "".join(json.dumps({"cmd": "decode", "args": [w(f"pack_{m}.pk"), "--recon", w(f"rc_dec_{m}.ply"),
                                                        "--platform", "device"]}) + "\n" for m in MODES)
    t = time.time()
    srv = subprocess.run([sys.executable, "-m", "nvfpcc_tpu_torch.serve"], cwd=ROOT, input=reqs,
                         capture_output=True, text=True, timeout=900)
    stats["decode_process_s"] = time.time() - t
    print(srv.stderr, end="")
    replies = [json.loads(line) for line in srv.stdout.splitlines() if line.strip()]
    if srv.returncode or replies != [{"ok": True, "status": 0}] * len(MODES):
        fail(f"the decode server exited {srv.returncode} with {replies}")
    for mode in MODES:
        row = stats[mode]
        row["parity"] = same_bytes(w(f"rc_enc_{mode}.ply"), w(f"rc_dec_{mode}.ply"))
        if not row["parity"] or row["n_points_rec"] == 0:
            fail(f"{mode}: rc_enc != rc_dec across processes, or an empty cloud")
        row["eval"] = run_eval(K, w("sphere.ply"), w(f"rc_dec_{mode}.ply"))
        log(f"mode {mode}: " + json.dumps(row))
    return stats


def mesh_numbers(out: str) -> dict:
    """The trainer's closing block-DP line: ranks, backend, all-reduces, the
    bytes of one and its time per net step on rank 0 (CUDA events)."""
    m = re.search(r"block-DP over (\d+) ranks \((\w+), (\w+)\): (\d+) gradient all-reduces of (\d+) bytes, "
                  r"one per net step; ([\d.]+) ms median, ([\d.]+) ms mean", out)
    if m is None:
        fail("no block-DP line in the trainer's log")
    return {"ranks": int(m[1]), "backend": m[2], "device": m[3], "allreduces": int(m[4]),
            "bytes_per_step": int(m[5]), "allreduce_ms_median": float(m[6]), "allreduce_ms_mean": float(m[7])}


def checkpoint_arrays(ck: str, epoch: int) -> dict:
    """Every param and the embeddings of the checkpoint of ``epoch`` in ``ck``."""
    from nvfpcc_tpu_torch.utils import checkpoint as C
    from nvfpcc_tpu_torch.utils.params import flatten_tree

    params, emb, _ = C.load_checkpoint_meta(os.path.join(ck, f"{epoch:04d}.npz"))
    return {**flatten_tree(params), "emb": emb}


def held(arrays: dict) -> dict:
    """The seven transmitted kernels and the embeddings."""
    from nvfpcc_tpu_torch.models.decoder import TRANSMITTED_KERNELS

    return {k: arrays[k] for k in [f"decoder/{n}/kernel" for n in TRANSMITTED_KERNELS] + ["emb"]}


def share_of_tolerance(got, ref, other_plain) -> float:
    """The largest of |got - ref| over its element's tolerance: the larger of
    MESH_SPREAD_FACTOR x |other_plain - ref| (the spread between two plain
    runs) and the CPU suite's bound MESH_ATOL + MESH_RTOL x |ref|."""
    ref = np.asarray(ref, np.float64)
    tol = np.maximum(MESH_SPREAD_FACTOR * np.abs(np.asarray(other_plain, np.float64) - ref),
                     MESH_ATOL + MESH_RTOL * np.abs(ref))
    return float((np.abs(np.asarray(got, np.float64) - ref) / tol).max())


def state_moments(ck: str, epoch: int) -> dict:
    """Both Adams' moments (``exp_avg``, ``exp_avg_sq``) in the train-state
    snapshot of ``epoch`` in ``ck``: after one step from a common state they
    move with the step's gradient, not through Adam's division by them."""
    with np.load(os.path.join(ck, f"state_{epoch:04d}.npz")) as z:
        return {k: z[k] for k in z.files if k.startswith(("opt/exp_avg", "emb_opt/exp_avg"))}


def rel_l2(got, ref) -> float:
    """||got - ref|| / ||ref|| over the whole array."""
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref) / max(float(np.linalg.norm(ref)), 1e-30))


def split_spread(torch, job: dict, q: int, snapshot) -> dict:
    """The first net step of a one-batch run of ``job`` (every block in the
    batch), from the init or from ``snapshot``: per parameter, ||the
    gradient summed from two half-batch calls - the one-call gradient|| and
    ||the one-call gradient||, in this process. cuDNN's sums depend on the
    batch a call holds, and the classifier heads' weight gradients cancel
    over the 43M voxels, so the split moves them far more than the order of
    the blocks does: the spread block-DP is held to."""
    from nvfpcc_tpu_torch.models import decoder as M
    from nvfpcc_tpu_torch.train import loop as TT
    from nvfpcc_tpu_torch.utils import checkpoint as C
    from nvfpcc_tpu_torch.utils.params import named_params, params_from_numpy

    mcfg, cfg, dev = job["model_cfg"], job["cfg"], torch.device("cuda")
    spec = M.build_model_spec(mcfg.ch, mcfg.channels, mcfg.seed_tag, mcfg.entropy_mode, mcfg.ctx_detach_pred,
                              mcfg.ctx_hidden, ctx_tail=mcfg.ctx_tail)
    net, n = TT.initial_params(spec, mcfg, dev), len(job["gt"])
    emb = M.init_embeddings(n, mcfg.ch, dev)
    if snapshot is not None:
        snap = C.load_train_state(snapshot)
        net = params_from_numpy(net, snap["params"])
        emb = torch.as_tensor(snap["emb"], device=dev)
    gt, dist = TT._prep_dense(job["gt"], job["dist"], dev)
    noise = TT.NoiseSource(cfg.seed, spec, dev)
    noise.start_epoch(q - 1, 1)
    nz = noise.draw((n,) + tuple(emb.shape[1:]), q)
    named = named_params(net)
    valid, n_pts = torch.ones(n, device=dev), torch.tensor(float(job["gt"].sum()), device=dev)

    def grads(rows, count_net):
        z = {**nz, "latent": nz["latent"][rows]} if "latent" in nz else nz
        loss, _ = TT.rd_loss(net, cfg, emb[rows], gt[rows], dist[rows], valid[rows], float(n_pts), "train", q, z,
                             cfg.compute_dtype, n_pts_override=n_pts, count_net=count_net)
        gs = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
        return [torch.zeros_like(p, dtype=torch.float64) if g is None else g.double() for p, g in zip(named.values(), gs)]

    one = grads(slice(0, n), True)
    two = [a + b for a, b in zip(grads(slice(0, n // 2), True), grads(slice(n // 2, n), False))]
    return {k: (float((b - a).norm()), float(a.norm())) for k, a, b in zip(named, one, two)}


def deterministic_train_on_mesh(mesh, jobs, echo=False):
    """``train_on_mesh`` under deterministic algorithms (a spawned rank
    starts a process of its own, without the parent's setting)."""
    import torch

    from nvfpcc_tpu_torch.train.loop import train_on_mesh

    torch.use_deterministic_algorithms(True)
    return train_on_mesh(mesh, jobs, echo=echo)


def phase_mesh(torch, K, w, n_points: int) -> dict:
    """Block-DP on the card. Under deterministic algorithms: two plain f32
    runs, NCCL at world size 1 through the CLI, gloo at world size 2 on the
    one card through the spawn helper, held against the plain run at every
    checkpoint. With cuDNN free: the three timed again. Then a bf16 mesh
    run; encode, decode in a second process and eval of the world-size-2
    checkpoint."""
    from nvfpcc_tpu_torch.cli import build_parser, train_job
    from nvfpcc_tpu_torch.parallel import run_group
    from nvfpcc_tpu_torch.tools.ctx_recipe import threshold_keeping
    from nvfpcc_tpu_torch.train.loop import train_on_mesh

    common = [w("sphere.ply"), "--depth", "10", "--level", "5", "--platform", "device"]
    f32 = ["--epochs", str(MESH_EPOCHS), "--phase_change", "1", "--eval_every", "1", "--compute_dtype", "f32"]
    with np.load(w("sphere_d10_l5_grids.npz")) as art:
        grids = {k: art[k] for k in ("origins", "gt", "dist")}

    def plain(name, flags=f32):
        t = time.time()
        out = run_cli(["train", *common, *flags, "--checkpoint_dir", w(f"ckpt_{name}"),
                       "--metrics", w(f"mesh_{name}.jsonl")])
        return {"train_s": time.time() - t, "epoch_s": epoch_seconds(out)}

    def nccl_w1(name):
        t = time.time()
        out = run_cli(["train", *common, *f32, "--checkpoint_dir", w(f"ckpt_{name}"), "--mesh",
                       "--metrics", w(f"mesh_{name}.jsonl")])
        row = {"train_s": time.time() - t, "epoch_s": epoch_seconds(out), **mesh_numbers(out)}
        if "[train] block-DP mesh over 1 devices" not in out or row["backend"] != "nccl":
            fail("train --mesh did not run one NCCL rank")
        return row

    def gloo_w2(name, fn, flags=f32):
        args = build_parser().parse_args(["train", *common, *flags, "--checkpoint_dir", w(f"ckpt_{name}"),
                                          "--metrics", w(f"mesh_{name}.jsonl")])
        job = train_job(args, grids, log=lambda line: None)
        t = time.time()
        ranks = run_group(fn, 2, "gloo", ["cuda:0", "cuda:0"], args=([job],), kwargs={"echo": True})
        out = "\n".join(ranks[0][0]["log"])
        if not np.array_equal(ranks[0][0]["emb"], ranks[1][0]["emb"]):
            fail("the two ranks ended with different embeddings")
        return {"train_s": time.time() - t, "epoch_s": epoch_seconds(out), **mesh_numbers(out)}

    # one net step over every block (the batch is the block count), then the
    # embedding update: from the init (q=1), and resumed from plain_a's
    # snapshot after epoch 0 (q=2, the embeddings' second Adam step)
    n_blocks = len(grids["origins"])
    one_step = {1: ["--epochs", "1", "--phase_change", "1", "--eval_every", "1", "--compute_dtype", "f32",
                    "--batchsize", str(n_blocks)],
                2: ["--epochs", "2", "--phase_change", "1", "--eval_every", "1", "--compute_dtype", "f32",
                    "--batchsize", str(n_blocks), "--resume"]}

    # the compared runs, deterministic
    det = {}
    torch.use_deterministic_algorithms(True)
    try:
        det["plain_a"], det["plain_b"] = plain("plain_a"), plain("plain_b")
        det["nccl_w1"] = nccl_w1("nccl_w1")
        det["gloo_w2"] = gloo_w2("gloo_w2", deterministic_train_on_mesh)
        spread = {}
        for q, flags in one_step.items():
            for name in (f"step_q{q}_plain", f"step_q{q}_gloo_w2"):
                os.makedirs(w(f"ckpt_{name}"))
                if q == 2:
                    shutil.copy(w("ckpt_plain_a/state_0000.npz"), w(f"ckpt_{name}"))
            det[f"step_q{q}_plain"] = plain(f"step_q{q}_plain", flags)
            det[f"step_q{q}_gloo_w2"] = gloo_w2(f"step_q{q}_gloo_w2", deterministic_train_on_mesh, flags)
            args = build_parser().parse_args(["train", *common, *flags])
            spread[q] = split_spread(torch, train_job(args, grids, log=lambda line: None), q,
                                     w("ckpt_plain_a/state_0000.npz") if q == 2 else None)
    finally:
        torch.use_deterministic_algorithms(False)

    check = {}
    metrics = {name: train_rows(w(f"mesh_{name}.jsonl")) for name in det}
    for name, rows in metrics.items():
        log(f"block-DP run {name} (deterministic): " + json.dumps(
            [{k: r[k] for k in ("epoch", "q", *MESH_METRICS, "lat_amax")} for r in rows]))
    for epoch in range(MESH_EPOCHS):
        a, b = (checkpoint_arrays(w(f"ckpt_{n}"), epoch) for n in ("plain_a", "plain_b"))
        check[f"plain_spread_epoch{epoch}"] = {k: float(np.abs(b[k].astype(np.float64) - v).max())
                                               for k, v in held(a).items()}
        if any(not np.array_equal(a[k], b[k]) for k in a):
            fail(f"two deterministic plain runs differ after epoch {epoch}: {check[f'plain_spread_epoch{epoch}']}")
        w1 = checkpoint_arrays(w("ckpt_nccl_w1"), epoch)
        if set(w1) != set(a) or any(not np.array_equal(w1[k], a[k]) for k in a):
            fail(f"world size 1 (NCCL) differs from plain train after epoch {epoch}")
        w2 = held(checkpoint_arrays(w("ckpt_gloo_w2"), epoch))
        check[f"gloo_w2_epoch{epoch}"] = {
            k: {"max_abs": float(np.abs(w2[k].astype(np.float64) - v).max()),
                "share_of_tolerance": share_of_tolerance(w2[k], v, b[k])}
            for k, v in held(a).items()}
        log(f"block-DP after epoch {epoch}: plain_b == plain_a and nccl_w1 == plain_a bit for bit; "
            f"gloo_w2 vs plain_a (reported, not held): " + json.dumps(check[f"gloo_w2_epoch{epoch}"]))
    if metrics["nccl_w1"] != metrics["plain_a"]:
        fail("world size 1 (NCCL) logged other metrics than plain train")
    shares = {f"{k}_epoch{e}": share_of_tolerance(m[k], pa[k], pb[k])
              for e, (pa, pb, m) in enumerate(zip(metrics["plain_a"], metrics["plain_b"], metrics["gloo_w2"]))
              for k in MESH_METRICS}
    for q in one_step:
        pa, m = metrics[f"step_q{q}_plain"][-1], metrics[f"step_q{q}_gloo_w2"][-1]
        shares.update({f"{k}_one_step_q{q}": share_of_tolerance(m[k], pa[k], pa[k]) for k in MESH_METRICS})
        epoch = q - 1
        ref, got = (state_moments(w(f"ckpt_step_q{q}_{n}"), epoch) for n in ("plain", "gloo_w2"))
        if set(got) != set(ref):
            fail(f"one-step snapshots hold other arrays: {sorted(set(got) ^ set(ref))}")
        # the net: both steps start from one exp_avg, so the difference of
        # the new ones is (1 - b1) x the difference of the gradients
        rows = {}
        for k, (diff_split, norm) in spread[q].items():
            d = float(np.linalg.norm(got[f"opt/exp_avg/{k}"].astype(np.float64) - ref[f"opt/exp_avg/{k}"])) / (1 - ADAM_B1)
            rows[k] = [d / max(norm, 1e-30), diff_split / max(norm, 1e-30),
                       d / max(MESH_SPREAD_FACTOR * diff_split, MESH_RTOL * norm, 1e-30)]
        # the embeddings: each row's gradient is its own block's
        for k in ("emb_opt/exp_avg", "emb_opt/exp_avg_sq"):
            rows[k] = [rel_l2(got[k], ref[k]), None, rel_l2(got[k], ref[k]) / MESH_RTOL]
        check[f"one_step_q{q}"] = rows
        pa_arr, w2_arr = (held(checkpoint_arrays(w(f"ckpt_step_q{q}_{n}"), epoch)) for n in ("plain", "gloo_w2"))
        moved = {k: float(np.abs(w2_arr[k].astype(np.float64) - v).max()) for k, v in pa_arr.items()}
        check[f"one_step_q{q}_params_max_abs"] = moved
        worst = max(rows, key=lambda k: rows[k][2])
        log(f"block-DP one step at q={q} (gloo_w2 vs plain from the same state): gradients within "
            f"{rows[worst][2]:.4f} of their tolerance ({worst}); params after the step differ by up to "
            f"{max(moved.values()):.3e} (reported); per array [relative L2 distance of the gradients, the same "
            f"plain gradient summed from two half-batch calls, share of the tolerance]: " + json.dumps(rows))
        if rows[worst][2] > 1.0:
            fail(f"block-DP one step at q={q}: the gradients left the tolerance: {rows}")
    check["gloo_w2_metrics_share_of_tolerance"] = shares
    log(f"block-DP gloo_w2: largest metric difference from plain as a share of its tolerance "
        f"{max(shares.values()):.4f} ({max(shares, key=shares.get)})")
    if max(shares.values()) > 1.0:
        fail(f"block-DP gloo_w2's metrics left the tolerance against plain train: {shares}")

    # the timed runs, cuDNN free
    runs = {"plain": plain("plain_timed"), "nccl_w1": nccl_w1("nccl_w1_timed"),
            "gloo_w2_one_card": gloo_w2("gloo_w2_timed", train_on_mesh)}

    out = run_cli(["train", *common, "--epochs", str(MESH_BF16_EPOCHS), "--phase_change", str(MESH_BF16_PHASE_CHANGE),
                   "--eval_every", "0", "--mesh", "--checkpoint_dir", w("ckpt_mesh_bf16"),
                   "--metrics", w("train_mesh_bf16.jsonl")])
    rows = train_rows(w("train_mesh_bf16.jsonl"))
    runs["nccl_w1_bf16"] = {"epoch_s": epoch_seconds(out), "loss": [r["loss"] for r in rows], **mesh_numbers(out)}
    q1 = [r["loss"] for r in rows if r["q"] == 1]
    if len(rows) != MESH_BF16_EPOCHS or not all(np.isfinite(r["loss"]) for r in rows) or not q1[-1] < q1[0]:
        fail(f"bf16 block-DP losses not finite or not falling within q=1: {runs['nccl_w1_bf16']['loss']}")

    thh = threshold_keeping(w("ckpt_gloo_w2"), n_points, "cuda")
    t = time.time()
    out = run_cli(["encode", *common, "--load_checkpoint", w("ckpt_gloo_w2"), "--pack_fn", w("pack_mesh.pk"),
                   "--recon", w("rc_enc_mesh.ply"), "--thh", str(thh)])
    codec_row = {"thh": thh, "encode_s": time.time() - t, **encode_numbers(out)}
    codec_row["decode_s"] = decode_in_second_process(w("pack_mesh.pk"), w("rc_dec_mesh.ply"))
    codec_row["parity"] = same_bytes(w("rc_enc_mesh.ply"), w("rc_dec_mesh.ply"))
    if not codec_row["parity"] or codec_row["n_points_rec"] == 0:
        fail("the world-size-2 checkpoint: rc_enc != rc_dec across processes, or an empty cloud")
    codec_row["eval"] = run_eval(K, w("sphere.ply"), w("rc_dec_mesh.ply"))
    log("block-DP codec: " + json.dumps(codec_row))
    log("seconds per epoch (trainer's log): " + ", ".join(
        f"{k} {v['epoch_s']}" for k, v in runs.items()) + " (gloo_w2_one_card: two ranks share one card, no speedup)"
        + "; deterministic: " + ", ".join(f"{k} {v['epoch_s']}" for k, v in det.items()))
    return {"runs": runs, "deterministic_runs": det, "check": check, "codec": codec_row}


def phase_tools(torch, K, w, n_points: int, thh: float) -> dict:
    """The README's workflow tools, run as a user runs them, on the channel
    phase's sphere, grids and checkpoint: ``encode_eval`` of the channel
    checkpoint (its pack byte-equal to the channel phase's), ``rd_sweep``
    (one lambda, one epoch, two thresholds that keep points; a rerun into
    its workdir trains nothing and gives the same rows; a row equal to
    ``encode_eval`` of the sweep's checkpoint), and ``pipeline_demo`` on the
    depth-9 sphere it synthesizes. Returns each tool's numbers and EDT
    launches."""
    from scripts.synth_cloud import bumpy_sphere_cloud
    from nvfpcc_tpu_torch.cli import write_ply_points
    from nvfpcc_tpu_torch.tools import encode_eval, pipeline_demo, rd_sweep
    from nvfpcc_tpu_torch.tools.ctx_recipe import threshold_keeping

    stats = {}
    os.makedirs(w("tools"))
    t = w("tools/")
    common = ["--depth", "10", "--level", "5", "--platform", "device"]

    # encode_eval: the channel checkpoint, copied so that its pack and
    # reconstructions do not replace the channel phase's
    shutil.copytree(w("ckpt"), t + "ckpt")
    before, t0 = K.LAUNCHES, time.time()
    ee = last_json(run_tool(encode_eval.main, [w("sphere.ply"), "--ckpt", t + "ckpt", "--thh", str(thh), "--no_d2",
                                               "--platform", "device"]))
    ee.update(seconds=time.time() - t0, launches=K.LAUNCHES - before,
              pack_equal_to_channel_phase=same_bytes(t + "pack.pk", w("pack.pk")))
    log("encode_eval: " + json.dumps(ee))
    if not (ee["parity"] and ee["pack_equal_to_channel_phase"] and np.isfinite(ee["d1_psnr"]) and ee["launches"] == 2):
        fail("encode_eval: no parity, a pack unlike the channel phase's, a D1 that is not finite, or not 2 EDT launches")
    stats["encode_eval"] = ee

    # rd_sweep: thresholds read off a probe trained as the sweep trains
    # (lambda 200, 1 epoch: the trainer snapshots every 10 epochs from
    # epoch 0, so the last epoch of a 1-epoch run is resumable)
    run_cli(["train", w("sphere.ply"), *common, "--epochs", str(RD_EPOCHS), "--checkpoint_dir", t + "probe"])
    thhs = [threshold_keeping(t + "probe", k * n_points, "cuda") for k in (1, 2)]
    rd_args = [w("sphere.ply"), *common, "--lambdas", "200", "--thhs", ",".join(map(str, thhs)),
               "--epochs", str(RD_EPOCHS), "--no_d2", "--workdir", t + "rd", "--out", t + "rd.jsonl"]
    runs = []
    for _ in range(2):
        before, t0 = K.LAUNCHES, time.time()
        out = run_tool(rd_sweep.main, rd_args)
        runs.append({"seconds": time.time() - t0, "launches": K.LAUNCHES - before,
                     "eval_lines": out.count("TEST]"), "snapshots": sorted(os.listdir(t + "rd/l200"))})
    rows = train_rows(t + "rd.jsonl")
    keys = ["lambda", "thh", "bpp", "b_latent", "b_net", "b_origins", "d1_psnr", "d1_mse", "n_points_rec",
            "n_points_src", "train_s"]
    strip = [{k: v for k, v in r.items() if k != "train_s"} for r in rows]
    log("rd_sweep: " + json.dumps({"thhs": thhs, "runs": runs, "rows": rows}))
    if len(rows) != 4 or any(list(r) != keys for r in rows) or strip[:2] != strip[2:]:
        fail("rd_sweep: not 2 rows a run with the JAX script's keys, or a rerun gave other rows")
    for r in rows:
        if not (np.isfinite(r["d1_psnr"]) and r["n_points_rec"] > 0 and r["n_points_src"] == n_points
                and abs(r["bpp"] - (r["b_net"] + r["b_latent"] + r["b_origins"])) < 1e-12):
            fail(f"rd_sweep row {r}: D1 not finite, no points, or bpp != b_net + b_latent + b_origins")
    if [r["eval_lines"] for r in runs] != [1, 0] or runs[0]["snapshots"] != runs[1]["snapshots"]:
        fail("rd_sweep: the rerun into the same workdir trained again")
    if [r["launches"] for r in runs] != [4, 4] or not torch.backends.cudnn.deterministic:
        fail("rd_sweep: not 2 EDT launches a row, or the codec's numerics were not in force after it")
    # the sweep's in-process row against a fresh encode + decode of the
    # checkpoint it trained (the last epoch's)
    before = K.LAUNCHES
    check = last_json(run_tool(encode_eval.main, [w("sphere.ply"), "--ckpt", t + "rd/l200", "--thh", str(thhs[0]),
                                                  "--no_d2", "--platform", "device"]))
    if not (check["parity"] and check["n_points_rec"] == rows[0]["n_points_rec"]
            and check["d1_psnr"] == round(rows[0]["d1_psnr"], 4)):
        fail(f"rd_sweep's row {rows[0]} differs from encode_eval of its checkpoint {check}")
    stats["rd_sweep"] = {"thhs": thhs, "runs": runs, "rows": rows[:2], "encode_eval": check,
                         "launches": sum(r["launches"] for r in runs) + K.LAUNCHES - before}

    # pipeline_demo at depth 9 (32^3 blocks) on the sphere it synthesizes;
    # its threshold read off a probe of the epoch-0 checkpoint its encode takes
    write_ply_points(t + "sphere9.ply", bumpy_sphere_cloud(9, radius=0.213), ascii=False)
    d9 = ["--depth", "9", "--level", "4", "--platform", "device"]
    before = K.LAUNCHES
    run_cli(["train", t + "sphere9.ply", *d9, "--epochs", "1", "--checkpoint_dir", t + "probe9"])
    with np.load(t + "sphere9_d9_l4_grids.npz") as art:
        n9 = int(art["gt"].sum())
    thh9 = threshold_keeping(t + "probe9", n9, "cuda")
    probe_launches, before, t0 = K.LAUNCHES - before, K.LAUNCHES, time.time()
    out = run_tool(pipeline_demo.main, ["--depth", "9", "--level", "4", "--epochs", str(PIPELINE_EPOCHS),
                                        "--thh", str(thh9), "--workdir", t + "pipeline", "--platform", "device"])
    pd = last_json(out)
    pd.update(seconds=time.time() - t0, launches=K.LAUNCHES - before, thh=thh9, n_points_src=n9)
    log("pipeline_demo: " + json.dumps(pd))
    if not (pd["parity"] and np.isfinite(pd["d1_psnr"]) and np.isfinite(pd["d2_psnr"]) and pd["launches"] == 5
            and "north star" in out):
        fail("pipeline_demo: no parity, D1 or D2 not finite, or not 5 EDT launches (grids 1, D1 2, D2 2)")
    stats["pipeline_demo"] = pd
    stats["launches"] = ee["launches"] + stats["rd_sweep"]["launches"] + probe_launches + pd["launches"]
    return stats


def launch_profile(torch, gt, dist, graphs: bool) -> dict:
    """A q=2 epoch's net steps at flagship width in bf16 (cuDNN free), after
    one warm epoch (which captures the graphs): CUDA-event milliseconds,
    and under ``torch.profiler`` the device's busy share, the kernels the
    device ran and the host's launch calls per net step."""
    from torch.profiler import ProfilerActivity, profile

    from nvfpcc_tpu_torch.tools.train_profile import EpochRunner, event_ms, kernel_table

    run = EpochRunner(gt, dist, "bf16", torch.device("cuda"), graphs=graphs)
    run.whole_epoch(2)
    ms = event_ms(lambda: run.net_steps(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run.net_steps(2)
        torch.cuda.synchronize()
    dev_us, kernels, _, calls = kernel_table(prof)
    n = run.n_batches
    return {"net_steps_ms": ms, "net_step_ms": ms / n,
            "device_busy_share": dev_us / 1e3 / ms,
            "device_kernels_per_step": kernels / n, "host_launch_calls_per_step": calls / n}


def phase_graphs(torch, w, n_blocks: int) -> dict:
    """CUDA graphs against eager on the sphere's grids at flagship width,
    under deterministic algorithms (``tools/graph_check.py``):
    ``train(graphs=True)`` and ``train(graphs=False)`` from the same init
    (GRAPH_RUNS: every entropy mode in bf16, channel in f32; then
    GRAPH_RESUME, both resumed from their own snapshot), every parameter,
    the embeddings, both Adams and every metric row equal bit for bit; then
    the ctx_post fit of the ctx run's latents both ways (one 250-step chunk
    a phase), the fitted tree equal bit for bit. With cuDNN free, the net
    steps' launches and device busy share both ways, on the sphere's first
    LAUNCH_PROFILE_BLOCKS blocks."""
    from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
    from nvfpcc_tpu_torch.models import decoder as M
    from nvfpcc_tpu_torch.tools.graph_check import bits_equal, graph_eager_pair
    from nvfpcc_tpu_torch.train import ctx_fit as TF
    from nvfpcc_tpu_torch.utils.params import flatten_tree, params_to_numpy

    with np.load(w("sphere_d10_l5_grids.npz")) as art:
        gt, dist = art["gt"], art["dist"]
    if len(gt) != n_blocks:
        fail(f"the graphs phase read {len(gt)} blocks, not the sphere's {n_blocks}")
    stats, ctx_state = {}, None
    pairs = [(f"{mode}_{dtype}_emb_chunks{chunks}", mode,
              TrainConfig(epochs=epochs, phase_change=phase_change, eval_every=eval_every, emb_chunks=chunks,
                          compute_dtype=dtype), None)
             for mode, chunks, epochs, phase_change, eval_every, dtype in GRAPH_RUNS]
    first, epochs, phase_change, eval_every = GRAPH_RESUME
    pairs.append((f"channel_bf16_resume{first}to{epochs}", "channel",
                  TrainConfig(epochs=epochs, phase_change=phase_change, eval_every=eval_every),
                  TrainConfig(epochs=first, phase_change=phase_change, eval_every=eval_every)))
    for name, mode, cfg, first_cfg in pairs:
        stats[name], run = graph_eager_pair(gt, dist, ModelConfig(entropy_mode=mode), cfg, w("."), name, first_cfg)
        log(f"graphs {name}: " + json.dumps(stats[name]))
        if not stats[name]["equal"]:
            fail(f"graph-replayed training differs from eager ({name}): {stats[name]['differ'][:8]}, "
                 f"metrics lines equal {stats[name]['metric_lines_equal']}")
        if mode == "ctx":
            ctx_state = run["state"]
        del run
    torch.use_deterministic_algorithms(True)
    try:
        spec = M.build_model_spec(3, (8, 16, 8, 8), entropy_mode="ctx_ar", ctx_hidden=32, ctx_tail=24)
        params = params_to_numpy(ctx_state.net)
        lat = TF.latents_from_checkpoint(spec, params, ctx_state.emb.detach().cpu().numpy(), "cuda")
        fits = {}
        for g in (True, False):
            fit_log = []
            tree = TF.fit_ctx_predictor(spec, lat, "cuda", wrate=params["decoder"]["wrate"], log=fit_log.append,
                                        graphs=g, **GRAPH_FIT)
            rate = float(fit_log[-1].split("(")[-1].split(" steps/s")[0])
            fits[g] = (flatten_tree(tree), rate)
        differ = bits_equal(fits[True][0], fits[False][0])
        stats["ctx_fit"] = {"steps_per_s_graphs": fits[True][1], "steps_per_s_eager": fits[False][1],
                            "n_blocks": len(lat), "differ": differ}
        log("graphs ctx_fit: " + json.dumps(stats["ctx_fit"]))
        if differ:
            fail(f"the graph-replayed ctx fit differs from eager: {differ}")
    finally:
        torch.use_deterministic_algorithms(False)
    for g in (True, False):
        n = LAUNCH_PROFILE_BLOCKS
        stats[f"launches_{'graphs' if g else 'eager'}"] = launch_profile(torch, gt[:n], dist[:n], g)
    log("graphs launches per net step: " + json.dumps({k: stats[k] for k in ("launches_graphs", "launches_eager")}))
    return stats


def phase_entry(torch) -> dict:
    """``tools/entry.py`` on the card: the eval forward over all 917 flagship
    blocks (shapes, finite), timed, and its first 8 blocks against the same
    forward on the CPU."""
    from nvfpcc_tpu_torch.tools.entry import entry

    fn, (net, emb) = entry()
    out, net_bits, lat = fn(net, emb)
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: fn(net, emb), 3)
    if tuple(out.shape) != (917, 32, 32, 32, 1) or tuple(net_bits.shape) != (7,) or not bool(torch.isfinite(out).all()):
        fail(f"entry: occupancy {tuple(out.shape)}, net bits {tuple(net_bits.shape)}, or a non-finite value")
    cfn, (cnet, cemb) = entry("cpu")
    want = [t.numpy() for t in cfn(cnet, cemb[:8])]
    got = [t.cpu().numpy() for t in fn(net, emb[:8])]
    errs = [float(np.abs(g - x).max()) for g, x in zip(got, want)]
    stats = {"forward_ms": ms, "latent_bits": float(lat), "net_bits": net_bits.cpu().tolist(),
             "max_abs_vs_cpu": dict(zip(("occupancy", "net_bits", "latent_bits"), errs))}
    log("entry: " + json.dumps(stats))
    for (g, x), (rtol, atol) in zip(zip(got, want), ENTRY_TOL):
        if not np.allclose(g, x, rtol=rtol, atol=atol):
            fail(f"entry: the card's forward differs from the CPU's beyond rtol {rtol} / atol {atol}: {errs}")
    return stats


def phase_bench(torch) -> dict:
    """``tools/bench.py`` as a user runs it, with one timed chunk: its first
    line is the card's, its last has ``bench.py``'s keys in order with
    finite values, and the codec's parity line is there."""
    from nvfpcc_tpu_torch.device import card_line
    from nvfpcc_tpu_torch.tools import bench

    t = time.time()
    lines = run_tool(bench.main, ["--timed_chunks", "1"]).splitlines()
    rows = [json.loads(line) for line in lines[1:] if line.startswith("{")]
    last = rows[-1]
    stats = {"seconds": time.time() - t, "last": last, "lines": rows[:-1]}
    log("bench: " + json.dumps(stats))
    numbers = [last[k] for k in ("value", "vs_baseline", "encode_ms", "decode_ms")]
    if lines[0] != card_line("cuda") or list(last) != BENCH_KEYS or not all(np.isfinite(numbers)):
        fail("bench: no card line first, another last line than bench.py's, or a value that is not finite")
    if last["epochs_per_dispatch"] != bench.EPOCHS_PER_DISPATCH:
        fail(f"bench: {last['epochs_per_dispatch']} epochs a dispatch, not bench.py's {bench.EPOCHS_PER_DISPATCH}")
    if [r.get("parity") for r in rows if "parity" in r] != [True]:
        fail("bench: no parity line")
    return stats


@contextlib.contextmanager
def edt_held_against_plain(K, seen: list, inputs: dict):
    """Inside the block, every EDT call that ``grids`` and ``eval`` make in
    this process goes through the kernel (counted as usual) and its result
    is held against the plain version on the same input, exactly; ``seen``
    gets (shape, radius, max |kernel - plain|, seconds of the check) of each
    call, ``inputs`` the first input of each (shape, radius)."""
    import torch

    from nvfpcc_tpu_torch.grids import builder
    from nvfpcc_tpu_torch.metrics import d1

    def checked(occ, radius):
        got = K.squared_edt_3d(occ, radius)
        torch.cuda.synchronize()
        t = time.time()
        err = int((got - K.squared_edt_3d_ref(occ, radius)).abs().max())
        seen.append((list(occ.shape), radius, err, time.time() - t))
        inputs.setdefault((tuple(occ.shape), radius), occ.clone())
        if err:
            fail(f"EDT kernel disagrees with the plain version at {tuple(occ.shape)} R={radius}")
        return got

    saved = builder.squared_edt_3d, d1.squared_edt_3d
    builder.squared_edt_3d = d1.squared_edt_3d = checked
    try:
        yield
    finally:
        builder.squared_edt_3d, d1.squared_edt_3d = saved


def phase_realdata(torch, K, w) -> tuple:
    """Both 8i-format fixtures (ascii PLY, float x/y/z + uchar colours) at
    the flagship width through the port CLI on the card: grids, a few bf16
    epochs, encode at a threshold read off the checkpoint, both packs
    decoded in one second process (``serve``), byte-equal to the encoder's
    clouds and not empty, eval (a finite D1). Every EDT call of the path is
    held against the plain version on the same input; ``grids_s`` and
    ``eval_s`` leave the seconds of those checks out. Returns the stats and
    the first EDT input of each (shape, radius)."""
    from nvfpcc_tpu_torch.cli import read_ply_points
    from nvfpcc_tpu_torch.tools.ctx_recipe import threshold_keeping

    stats, edts, inputs = {}, [], {}

    def without_checks(fn):
        """(fn(), its seconds less those of the EDT checks made inside it)."""
        t, checks = time.time(), sum(e[3] for e in edts)
        out = fn()
        return out, time.time() - t - (sum(e[3] for e in edts) - checks)

    with edt_held_against_plain(K, edts, inputs):
        for name, fixture in REALDATA:
            shutil.copy(os.path.join(ROOT, "tests", "fixtures", fixture), w(f"{name}.ply"))
            common = [w(f"{name}.ply"), "--depth", "10", "--level", "5", "--platform", "device"]
            _, grids_s = without_checks(lambda: run_cli(["grids", *common]))
            row = {"grids_s": grids_s}
            with np.load(w(f"{name}_d10_l5_grids.npz")) as art:
                per_block = art["gt"].reshape(len(art["gt"]), -1).sum(1)
            row.update(n_blocks=len(per_block), n_points=int(per_block.sum()),
                       points_per_block=[int(per_block.min()), int(per_block.max())])
            t = time.time()
            out = run_cli(["train", *common, "--epochs", str(TRAIN_EPOCHS), "--phase_change", str(PHASE_CHANGE),
                           "--eval_every", str(EVAL_EVERY), "--checkpoint_dir", w(f"ckpt_{name}"),
                           "--metrics", w(f"train_{name}.jsonl")])
            rows = train_rows(w(f"train_{name}.jsonl"))
            row.update(train_s=time.time() - t, epoch_s=epoch_seconds(out), loss=[r["loss"] for r in rows])
            if len(rows) != TRAIN_EPOCHS or not all(np.isfinite(row["loss"])):
                fail(f"realdata {name}: train rows {rows}")
            row["thh"] = thh = threshold_keeping(w(f"ckpt_{name}"), row["n_points"], "cuda")
            t = time.time()
            out = run_cli(["encode", *common, "--load_checkpoint", w(f"ckpt_{name}"), "--pack_fn",
                           w(f"pack_{name}.pk"), "--recon", w(f"rc_enc_{name}.ply"), "--thh", str(thh)])
            row.update(encode_s=time.time() - t, **encode_numbers(out))
            if row["n_points_rec"] == 0:
                fail(f"realdata {name}: the reconstruction at thh {thh} is empty; pass a lower --thh")
            stats[name] = row

        # one second process decodes both packs
        reqs = "".join(json.dumps({"cmd": "decode", "args": [w(f"pack_{n}.pk"), "--recon", w(f"rc_dec_{n}.ply"),
                                                            "--platform", "device"]}) + "\n" for n, _ in REALDATA)
        t = time.time()
        srv = subprocess.run([sys.executable, "-m", "nvfpcc_tpu_torch.serve"], cwd=ROOT, input=reqs,
                             capture_output=True, text=True, timeout=900)
        stats["decode_process_s"] = time.time() - t
        print(srv.stderr, end="")
        replies = [json.loads(line) for line in srv.stdout.splitlines() if line.strip()]
        if srv.returncode or replies != [{"ok": True, "status": 0}] * len(REALDATA):
            fail(f"the decode server exited {srv.returncode} with {replies}")
        for name, _ in REALDATA:
            row = stats[name]
            row["parity"] = same_bytes(w(f"rc_enc_{name}.ply"), w(f"rc_dec_{name}.ply"))
            if not row["parity"] or len(read_ply_points(w(f"rc_dec_{name}.ply"))) == 0:
                fail(f"realdata {name}: rc_enc != rc_dec across processes, or an empty cloud")
            row["eval"], eval_s = without_checks(lambda: run_eval(K, w(f"{name}.ply"), w(f"rc_dec_{name}.ply")))
            row["eval"]["eval_s"] = eval_s
            if not np.isfinite(row["eval"]["d1_psnr"]):
                fail(f"realdata {name}: D1 is not finite")
            log(f"realdata {name}: " + json.dumps(row))
    stats["edt_calls"] = edts
    log(f"realdata EDT calls (shape, radius, max |kernel - plain|, check s): {edts}")
    return stats, inputs


def time_edt_inputs(K, inputs: dict) -> list:
    """The kernel, its plain version and its bytes bound on each of the
    real-data path's EDT inputs (run after the path's launches are read)."""
    timed = []
    for (shape, radius), occ in inputs.items():
        row = {"shape": list(shape), "radius": radius, "ms": cuda_ms(lambda: K.squared_edt_3d(occ, radius), 10),
               "plain_ms": cuda_ms(lambda: K.squared_edt_3d_ref(occ, radius), 2),
               "bound_ms": occ.numel() * EDT_BYTES_PER_VOXEL / HBM_BYTES_PER_S * 1e3}
        timed.append(row)
        log(f"edt {list(shape)} R={radius} (real-data input): kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f}% of it)")
    return timed


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=os.path.join(ROOT, ".work", "chip_smoke"))
    args = ap.parse_args()
    t_start = time.time()
    # cuBLAS reads it at its first call; the block-DP phase's deterministic
    # runs need it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, ROOT)
    from nvfpcc_tpu_torch.device import card_line
    from nvfpcc_tpu_torch.kernels import conv3d as C3
    from nvfpcc_tpu_torch.kernels import conv_transpose as CT
    from nvfpcc_tpu_torch.kernels import edt as K

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = card_line("cuda")
    log(f"device {kind} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    print(smi, flush=True)

    # 2-3. kernel build and kernel vs plain
    kstats = phase_kernel(torch, K)
    cstats = phase_conv_kernel(torch, CT)
    dstats = phase_direct_conv_kernel(torch, C3, CT, cstats["timed"])
    CT.LAUNCHES = C3.LAUNCHES = 0

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

    t = time.time()
    tstats = phase_train(torch, w, len(origins))
    secs["train"] = time.time() - t

    # encode takes the checkpoint just trained
    from nvfpcc_tpu_torch.tools.ctx_recipe import threshold_keeping

    thh = threshold_keeping(w("ckpt"), len(pts), "cuda")
    log(f"encode --thh {thh}: {TRAIN_EPOCHS} epochs do not reach the default threshold, so the "
        f"occupancy level that keeps about {len(pts)} voxels is used")
    t = time.time()
    run_cli(["encode", w("sphere.ply"), "--depth", "10", "--level", "5",
             "--load_checkpoint", w("ckpt"), "--pack_fn", w("pack.pk"),
             "--recon", w("rc_enc.ply"), "--thh", str(thh), "--platform", "device"])
    secs["encode"] = time.time() - t
    log(f"encode: pack {os.path.getsize(w('pack.pk'))} bytes")

    secs["decode"] = decode_in_second_process(w("pack.pk"), w("rc_dec.ply"))
    parity = same_bytes(w("rc_enc.ply"), w("rc_dec.ply"))
    from nvfpcc_tpu_torch.cli import read_ply_points

    n_rec = len(read_ply_points(w("rc_dec.ply")))
    log(f"rc_enc.ply == rc_dec.ply bit-exact across processes: {parity} ({n_rec} points)")
    if not parity or n_rec == 0:
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

    ev = run_eval(K, w("sphere.ply"), w("rc_dec.ply"))
    secs["eval"], eval_launches = ev["eval_s"], ev["launches"]
    log(f"eval: EDT launches {eval_launches}")
    launches = K.LAUNCHES
    log("seconds per stage: " + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    log("train: " + json.dumps(tstats))

    # 4a. CUDA-graph training and the ctx fit against eager; no EDT launch
    K.LAUNCHES = 0
    t = time.time()
    gstats = phase_graphs(torch, w, len(origins))
    log(f"graphs path: {time.time() - t:.2f} s, EDT launches {K.LAUNCHES}")
    if K.LAUNCHES:
        fail("the graphs phase launched the EDT kernel")

    # 4b. the workflow tools on the channel phase's sphere, grids and
    # checkpoint; their own launch count
    K.LAUNCHES = 0
    t = time.time()
    tools_stats = phase_tools(torch, K, w, len(pts), thh)
    tools_launches = K.LAUNCHES
    log(f"tools path: {time.time() - t:.2f} s, EDT launches {tools_launches}")
    if tools_launches != tools_stats["launches"]:
        fail(f"the tools phase counted {tools_stats['launches']} EDT launches of {tools_launches}")

    # 5. the context-model path on the same grids; its own launch count
    K.LAUNCHES = 0
    t = time.time()
    xstats = phase_ctx(torch, K, w, len(pts), len(origins))
    ctx_launches = K.LAUNCHES
    phase_mode_fixture(3, "ctx")
    log(f"ctx path: {time.time() - t:.2f} s, EDT launches {ctx_launches}")
    log("ctx: " + json.dumps({k: ({kk: vv for kk, vv in v.items() if kk != "fit_log"} if isinstance(v, dict) else v)
                              for k, v in xstats.items()}))
    if ctx_launches < 1:
        fail("the ctx path did not launch the EDT kernel")

    # 6. bf16 reconstruction of the channel checkpoint; its own launch count
    K.LAUNCHES = 0
    t = time.time()
    bstats = phase_bf16(torch, K, w, thh)
    bf16_launches = K.LAUNCHES
    log(f"bf16 path: {time.time() - t:.2f} s, EDT launches {bf16_launches}")

    # 7. the spatio, gmm and factorized modes on the same grids
    K.LAUNCHES = 0
    t = time.time()
    mstats = phase_modes(torch, K, w, len(pts), len(origins))
    modes_launches = K.LAUNCHES
    phase_mode_fixture(2, "spatio")
    log(f"modes path: {time.time() - t:.2f} s, EDT launches {modes_launches}")

    # 8. D2 of the channel reconstruction: 2 EDT launches for D1, 2 for D2
    K.LAUNCHES = 0
    d2 = run_eval(K, w("sphere.ply"), w("rc_dec.ply"), "--d2")
    d2_launches = K.LAUNCHES
    log("eval --d2: " + json.dumps(d2))
    if d2_launches != 4 or "d2_psnr" not in d2:
        fail(f"eval --d2 launched the EDT kernel {d2_launches} times (4 expected) or printed no D2")
    # 9. block-DP at the flagship width on the same grids
    K.LAUNCHES = 0
    t = time.time()
    mesh_stats = phase_mesh(torch, K, w, len(pts))
    mesh_launches = K.LAUNCHES
    log(f"block-DP path: {time.time() - t:.2f} s, EDT launches {mesh_launches}")

    # 10. the single-card forward check and the headline bench at flagship
    # width; neither path runs the EDT
    K.LAUNCHES = 0
    t = time.time()
    entry_stats = phase_entry(torch)
    bench_stats = phase_bench(torch)
    log(f"entry and bench: {time.time() - t:.2f} s, EDT launches {K.LAUNCHES}")
    if K.LAUNCHES:
        fail("the forward check or the bench launched the EDT kernel")

    # 11. the 8i-format real-data path: grids 1 and eval 2 EDT launches a fixture
    K.LAUNCHES = 0
    t = time.time()
    rstats, edt_inputs = phase_realdata(torch, K, w)
    realdata_launches = K.LAUNCHES
    log(f"realdata path: {time.time() - t:.2f} s, EDT launches {realdata_launches}")
    if realdata_launches != 3 * len(REALDATA) or len(rstats["edt_calls"]) != realdata_launches:
        fail(f"the real-data path launched the EDT kernel {realdata_launches} times ({3 * len(REALDATA)} expected)")
    kstats["realdata_timed"] = time_edt_inputs(K, edt_inputs)
    del edt_inputs
    log("summary: " + json.dumps({
        "tools": {"encode_eval": {k: tools_stats["encode_eval"][k] for k in ("encode_s", "decode_s", "bpp", "d1_psnr")},
                  "rd_sweep": [{k: r[k] for k in ("thh", "bpp", "d1_psnr", "n_points_rec", "train_s")}
                               for r in tools_stats["rd_sweep"]["rows"]],
                  "pipeline_demo": {k: v for k, v in tools_stats["pipeline_demo"].items() if k.endswith("_s")}},
        "bf16": {k: bstats[k] for k in ("flip_share", "parity")} | {
            k: v["median_ms"] for k, v in bstats["warm_decode"].items()},
        "modes": {m: {k: mstats[m][k] for k in ("epoch_s", "bpp", "b_latent", "b_net", "b_origins",
                                                "latent_table_bits", "parity")} for m in MODES},
        "mode_decode_process_s": mstats["decode_process_s"],
        "d2": d2,
        "mesh": {k: {kk: v[kk] for kk in ("epoch_s", "bytes_per_step", "allreduce_ms_median") if kk in v}
                 for k, v in mesh_stats["runs"].items()},
        "graphs": {k: ({kk: vv for kk, vv in v.items() if kk != "differ"} if isinstance(v, dict) else v)
                   for k, v in gstats.items()},
        "entry_forward_ms": entry_stats["forward_ms"],
        "bench": bench_stats["last"],
        "realdata": {n: {k: rstats[n][k] for k in ("n_blocks", "thh", "bpp", "n_points_rec", "parity", "grids_s",
                                                   "train_s", "encode_s")} | {"d1_psnr": rstats[n]["eval"]["d1_psnr"]}
                     for n, _ in REALDATA},
    }))
    shutil.rmtree(args.workdir, ignore_errors=True)
    log(f"total {time.time() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "squared_edt_3d",
        "route": "cuda",
        "source": "nvfpcc_tpu_torch/csrc/edt.cu",
        "replaces": "nvfpcc_tpu/ops/pallas/edt_pallas.py:157",
        "launches": launches + tools_launches + ctx_launches + bf16_launches + modes_launches + d2_launches
        + mesh_launches + realdata_launches,
        "launches_by_stage": {"grids": grids_launches, "eval": eval_launches, "tools": tools_launches,
                              "ctx_eval": ctx_launches, "bf16_eval": bf16_launches, "modes_eval": modes_launches,
                              "eval_d2": d2_launches, "mesh_eval": mesh_launches, "realdata": realdata_launches},
        **kstats,
    }, {
        "name": "conv_transpose3d",
        "route": "cuda",
        "source": "nvfpcc_tpu_torch/csrc/conv_transpose.cu",
        "replaces": None,
        "launches": CT.LAUNCHES,
        **cstats,
    }, {
        "name": "conv3d",
        "route": "cuda",
        "source": "nvfpcc_tpu_torch/csrc/conv3d.cu",
        "replaces": None,
        "launches": C3.LAUNCHES,
        **dstats,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
