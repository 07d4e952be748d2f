"""The decode window: a warm receiver decoding frames back to back.

Set-up makes ``packs`` frames from the seed: per frame a trained-like
params tree (kernel residuals on the 1/16 grid) and integer latents, each
drawn at the traffic's statistics of a trained pack, the
octree origins of the configuration's blocks, and the threshold at which
the reference's reconstruction keeps ``n_points`` voxels; the program's
``codec.encode`` packs each frame once into a file under ``TMPDIR``, and
the program decodes each once to warm up. The window is one client in a
closed loop (``closed_loop.run``): each request is ``codec.load_pack``
plus ``codec.decode`` of the next frame, timed on its own up to the
device's finish, until the requests' times add up to ``--seconds``.
``decode_ms`` is that sum over the decodes; the client's comparison of
each answer with the ones it keeps, between requests, is outside it.

With ``--trace 1`` the window also times ``codec.reconstruct_points`` and
the host coders (``codec.load_pack``, ``weights.unpack_weights``,
``codec.decode_latent_pack``, ``codec.decode_origins``), each span ending
after the device's work; after it ``TRACE_DECODES`` more decodes run under
``torch.profiler``.

After the window the reference reconstructs every frame in float32 from
the frame's own residuals, latents and origins, and every decode of the
window is compared with it (``compare.point_gap``): the window kept one
array per distinct answer, and a decode that repeats an earlier one's
bytes reads that one's gap.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from benchmark import closed_loop, counters, generators, tracing
from benchmark.harness import Outcome
from benchmark.reference import compare
from benchmark.reference.nvfpcc import Model, reconstruct

TRACE_DECODES = 2  # decodes under the profiler after the window


def frame(cfg: dict, traffic: dict, model: Model, rng: np.random.Generator, origins: np.ndarray, dev):
    """One frame: (params by path, integer latents (N, 2, 2, 2, ch) float32,
    the threshold at which the reference keeps ``n_points`` voxels)."""
    ch, n = cfg["ch"], len(origins)
    mean, sd = np.asarray(traffic["latent"], np.float64).T
    latents = np.rint(rng.normal(mean, sd, (n, 2, 2, 2, ch))).astype(np.float32)
    inits = {k: (v[0].cpu().numpy(), v[1].cpu().numpy()) for k, v in model.init.items()}
    params = generators.decode_params(rng, inits, cfg, traffic)
    occ = occupancy(model, params, latents, dev).reshape(-1)
    top = torch.topk(occ, int(cfg["n_points"]) + 1).values
    thh = np.float32(0.5 * (float(top[-2]) + float(top[-1])))
    return params, latents, float(thh)


def occupancy(model: Model, params: dict, latents: np.ndarray, dev, precision: str = "f32") -> torch.Tensor:
    """The reference's occupancy (N, 32, 32, 32) float32 on ``dev``: TF32
    off, cuDNN free to pick its algorithms (the decoder pins its own)."""
    p = {k: torch.from_numpy(v).to(dev) for k, v in params.items() if k.startswith("decoder/")}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = False
    try:
        return reconstruct(model, p, torch.from_numpy(latents).to(dev), precision=precision)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.deterministic = flags


def run(ctx) -> Outcome:
    from nvfpcc_tpu_torch import codec
    from nvfpcc_tpu_torch.codec import codec as codec_mod
    from nvfpcc_tpu_torch.codec import weights as W
    from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig
    from nvfpcc_tpu_torch.utils.params import unflatten_tree

    cfg, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    c = cfg["codec"]
    rng = np.random.default_rng(ctx.seed)
    model = Model(cfg, dev)
    mcfg = ModelConfig(ch=cfg["ch"], chanstr=cfg["chanstr"], seed_tag=cfg["seed_tag"],
                       entropy_mode=cfg["entropy_mode"])
    workdir = tempfile.mkdtemp(prefix="nvfpcc_bench_")
    frames, paths = [], []
    for i in range(int(traffic["packs"])):
        origins = generators.synthetic_origins(int(cfg["n_blocks"]), c["depth"], c["level"], int(rng.integers(1 << 62)))
        params, latents, thh = frame(cfg, traffic, model, rng, origins, dev)
        ccfg = CodecConfig(thh_encode=thh, qp=c["qp"], depth=c["depth"], level=c["level"], recon_dtype=c["recon_dtype"])
        res = codec.encode(unflatten_tree(params), latents, origins, mcfg, ccfg, int(cfg["n_points"]), dev)
        path = os.path.join(workdir, f"frame{i}.pk")
        codec.save_pack(path, res.pack)
        paths.append(path)
        frames.append((origins, thh, params, latents))
    for path in paths:  # warm up: one decode of each frame
        codec.decode(codec.load_pack(path), dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    # -- the window
    recon, host = [], {"load_pack": [], "unpack_weights": [], "decode_latent_pack": [], "decode_origins": []}
    spans = []
    if ctx.trace:
        spans = [tracing.host_span(codec_mod, "reconstruct_points", recon, dev),
                 tracing.host_span(codec, "load_pack", host["load_pack"]),
                 tracing.host_span(W, "unpack_weights", host["unpack_weights"]),
                 tracing.host_span(codec_mod, "decode_latent_pack", host["decode_latent_pack"]),
                 tracing.host_span(codec_mod, "decode_origins", host["decode_origins"])]
    loop = closed_loop.run(lambda i: codec.decode(codec.load_pack(paths[i]), dev)[0], len(paths), ctx.seconds,
                          dev, ctx.log)
    for s in spans:
        s.restore()
    n_dec = len(loop.keys)
    n = int(cfg["n_blocks"])
    flops, bytes_ = counters.decode_work(cfg, n, -(-n // 128))
    obs = {"kind": "decode", "window_s": loop.timed_s, "decodes": n_dec,
           "flops_per_decode": flops, "least_s_per_decode": counters.least_seconds(flops, bytes_, "f32"),
           "peak_flops": counters.PEAK_FLOPS["f32"]}
    busy_s = stretch_s = breakdown = None
    if ctx.trace:
        obs["recon_ms"] = [1e3 * s for s in recon]
        obs["host_decode_ms"] = [1e3 * sum(v) for v in zip(*host.values())]
        label = tracing.annotated(codec_mod, "reconstruct_points", "bench.reconstruct_points")
        with torch.profiler.profile(activities=tracing.activities(dev)) as prof:
            with torch.profiler.record_function("bench.stretch"):
                for j in range(TRACE_DECODES):
                    codec.decode(codec.load_pack(paths[j % len(paths)]), dev)
        label.restore()
        devs, hst = tracing.events(prof, cuda)
        win = tracing.annotation_windows(hst, "bench.stretch")
        start, end = win[0] if win else (devs[0][0], devs[-1][1])
        stretch_s = (end - start) / 1e9
        busy_s = tracing.busy_ns(devs, [(start, end)]) / 1e9
        obs.update(stretch_s=stretch_s, stretch_busy_s=busy_s, stretch_decodes=TRACE_DECODES,
                   recon_busy_s=tracing.busy_ns(devs, tracing.annotation_windows(hst, "bench.reconstruct_points")) / 1e9)
        breakdown = {"device_ops": tracing.top_ops(devs), "idle_gaps": tracing.idle_gaps(devs, hst, start, end)}
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # -- the check: every decode of the window against the reference
    t_ref = time.perf_counter()
    refs = [occupancy(model, params, latents, dev).cpu().numpy() for _o, _t, params, latents in frames]
    gaps = loop.gaps(lambda i, points: compare.point_gap(points, frames[i][0], refs[i], frames[i][1])[0])
    ctx.log(f"[decode] reference {time.perf_counter() - t_ref:.1f} s")
    limit = float(ctx.limits["point_gap"])
    for path in paths:
        os.remove(path)
    os.rmdir(workdir)
    return Outcome(
        end_to_end={"decode_ms": loop.timed_s / n_dec * 1e3, "setup_s": setup_s},
        checks={"point_gap": max(gaps)}, attempted=n_dec, failed=sum(g > limit for g in gaps),
        memory_peak_bytes=peak, obs=obs, busy_s=busy_s, window_s=stretch_s, breakdown=breakdown,
    )
