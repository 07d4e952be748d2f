"""The decode window of ctx_ar + ctx_post packs: a warm receiver decoding
frames whose latents the host ctx coder codes.

Set-up makes ``packs`` frames from the seed. Each starts as a frame of
``drivers/decode.py`` (the configuration's octree origins, a trained-like
decoder, integer latents drawn at the traffic's statistics, and the
threshold at which the reference's reconstruction keeps ``n_points``
voxels). The program then fits the configuration's ctx predictor on the
frame's latents (``train/ctx_fit.py:upgrade_params_to_ctx`` at its
defaults, the weight rate priced from the frame's ``decoder/wrate``: what
``encode --ctx_post`` runs), and its ``codec.encode`` writes the pack
into a file under ``TMPDIR``. Each pack is decoded once to warm up.

The window is one client in a closed loop, as in ``drivers/decode.py``
(``closed_loop.run``): each request is ``codec.load_pack`` plus
``codec.decode`` of the next frame, timed on its own up to the device's
finish, until the requests' times add up to ``--seconds``; ``decode_ms``
is that sum over the decodes. With
``--trace 1``, ``TRACE_DECODES`` more decodes run after the window under
``torch.profiler``, the process's only profile; the log gives the tables
each of their ctx decodes built.

The check: after the window the f32 reference (TF32 off) reconstructs
every frame from its drawn latents, and every decode of the window is
compared with it (``compare.point_gap``; a decode that repeats an
earlier one's bytes reads that one's gap). A latent the encoder had to
clamp to the coder's alphabet is the one place where the coded latents
may differ from the drawn: the driver asserts that the program's ctx
encode (``encode_latents_ctx``, whose ``coded`` it catches) changed
exactly ``n_clamped`` of them, and the reference takes the coded value
there alone. A latent that the ctx coder decodes wrong changes its
block's occupancy far from the threshold, so the check holds the coder
as well as the reconstruction. The log gives each frame's clamped
symbols and its stream's bits beside the reference predictor's
(``reference/ctx_ar.py``) Gaussian bits of the reference latents.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from benchmark import closed_loop, counters, generators, tracing
from benchmark.drivers.decode import TRACE_DECODES, frame, occupancy
from benchmark.harness import Outcome
from benchmark.reference import compare, ctx_ar
from benchmark.reference.nvfpcc import Model, gaussian_bits


def decoder_model(cfg: dict, dev) -> Model:
    """The reference's decoder for ``cfg``: the decoder's layers and seeded
    inits do not depend on the entropy model (``reference/nvfpcc.py``
    models the channel one; the ctx_ar predictor is ``reference/ctx_ar.py``)."""
    return Model({**cfg, "entropy_mode": "channel"}, dev)


def pack_frame(cfg: dict, traffic: dict, model: Model, rng: np.random.Generator, dev, log=print):
    """One frame packed by the program: (pack, frame), the frame a dict of
    ``origins``, ``thh``, ``params`` (the drawn tree, flat by path),
    ``latents`` (the reference's: the drawn ones, float32, with the
    program's coded value where the encoder clamped one), ``clamped`` (the
    symbols clamped to the alphabet) and ``entropy`` (the fitted
    predictor's residual tree)."""
    from nvfpcc_tpu_torch import codec
    from nvfpcc_tpu_torch.coder import ctx_coder
    from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig
    from nvfpcc_tpu_torch.train.ctx_fit import upgrade_params_to_ctx
    from nvfpcc_tpu_torch.utils.params import unflatten_tree

    c = cfg["codec"]
    origins = generators.synthetic_origins(int(cfg["n_blocks"]), c["depth"], c["level"], int(rng.integers(1 << 62)))
    params, latents, thh = frame(cfg, traffic, model, rng, origins, dev)
    mcfg = ModelConfig(ch=cfg["ch"], chanstr=cfg["chanstr"], seed_tag=cfg["seed_tag"],
                       entropy_mode=cfg["entropy_mode"], ctx_hidden=cfg["ctx_hidden"], ctx_tail=cfg["ctx_tail"])
    # the drawn tree's channel Gaussians give way to the fitted predictor
    tree = unflatten_tree({k: v for k, v in params.items() if not k.startswith("entropy/")})
    tree = upgrade_params_to_ctx(codec.model_spec(mcfg), tree, latents, dev, log=log)
    ccfg = CodecConfig(thh_encode=thh, qp=c["qp"], depth=c["depth"], level=c["level"], recon_dtype=c["recon_dtype"])
    coded = []

    def keep(fn):
        def wrapper(*args, **kwargs):
            coded.append(fn(*args, **kwargs))
            return coded[-1]
        return wrapper

    wrapped = tracing.Wrapped(ctx_coder, "encode_latents_ctx", keep)
    try:
        res = codec.encode(tree, latents, origins, mcfg, ccfg, int(cfg["n_points"]), dev)
    finally:
        wrapped.restore()
    (enc,) = coded
    moved = enc["coded"] != latents
    if int(moved.sum()) != int(enc["n_clamped"]):
        raise RuntimeError(f"the ctx encode changed {int(moved.sum())} latents and clamped {enc['n_clamped']}")
    ref_latents = np.where(moved, enc["coded"], latents).astype(np.float32)
    return res.pack, {"origins": origins, "thh": thh, "params": params, "latents": ref_latents,
                      "clamped": int(enc["n_clamped"]), "entropy": tree["entropy"]}


def reference_bits(cfg: dict, fr: dict, dev) -> float:
    """Gaussian bits of the frame's reference latents under the reference's
    float predictor with the pack's kernels (its rounded residuals)."""
    pred = ctx_ar.CtxAR(cfg["ch"], cfg["ctx_hidden"], cfg["ctx_tail"], dev, cfg["seed_tag"])
    y = torch.from_numpy(fr["latents"]).to(dev)
    mu, sigma = pred.predict(y, pred.kernels(fr["entropy"]))
    with torch.no_grad():
        return float(gaussian_bits(y, sigma, mu).double().sum())


def log_ctx_counts(log) -> None:
    """The counts of the program's ``codec.latents.ctx`` spans (its mode,
    steps, symbols and the tables it built), where the program has them."""
    try:
        from nvfpcc_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return
    counts = [getattr(s, "counts", None) for s in trace.spans() if s.name == "codec.latents.ctx"]
    log(f"[decode_ctx] ctx decodes profiled: {counts}")


def run(ctx) -> Outcome:
    from nvfpcc_tpu_torch import codec
    from nvfpcc_tpu_torch.codec import codec as codec_mod

    cfg, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(ctx.seed)
    model = decoder_model(cfg, dev)
    workdir = tempfile.mkdtemp(prefix="nvfpcc_bench_")
    frames, paths, stream_bits = [], [], []
    for i in range(int(traffic["packs"])):
        pack, fr = pack_frame(cfg, traffic, model, rng, dev, log=ctx.log)
        path = os.path.join(workdir, f"frame{i}.pk")
        codec.save_pack(path, pack)
        stream_bits.append(8 * len(pack["latent_pack"]["stream"]))
        paths.append(path)
        frames.append(fr)
    for path in paths:  # warm up: one decode of each frame
        codec.decode(codec.load_pack(path), dev)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    # -- the window
    loop = closed_loop.run(lambda i: codec.decode(codec.load_pack(paths[i]), dev)[0], len(paths), ctx.seconds,
                          dev, ctx.log)
    n_dec = len(loop.keys)
    n = int(cfg["n_blocks"])
    # the decoder's chain, which the entropy model does not change (as decoder_model)
    flops, bytes_ = counters.decode_work({**cfg, "entropy_mode": "channel"}, n, -(-n // 128))
    obs = {"kind": "decode", "window_s": loop.timed_s, "decodes": n_dec,
           "flops_per_decode": flops, "least_s_per_decode": counters.least_seconds(flops, bytes_, "f32"),
           "peak_flops": counters.PEAK_FLOPS["f32"]}
    busy_s = stretch_s = breakdown = None
    if ctx.trace:
        label = tracing.annotated(codec_mod, "reconstruct_points", "bench.reconstruct_points")
        with torch.profiler.profile(activities=tracing.activities(dev)) as prof:
            with torch.profiler.record_function("bench.stretch"):
                for j in range(TRACE_DECODES):
                    codec.decode(codec.load_pack(paths[j % len(paths)]), dev)
        label.restore()
        log_ctx_counts(ctx.log)
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

    # -- the check: every decode of the window against the reference of the drawn latents
    t_ref = time.perf_counter()
    refs = [occupancy(model, fr["params"], fr["latents"], dev).cpu().numpy() for fr in frames]
    gaps = loop.gaps(lambda i, points: compare.point_gap(points, frames[i]["origins"], refs[i], frames[i]["thh"])[0])
    for i, fr in enumerate(frames):
        ctx.log(f"[decode_ctx] frame {i}: {fr['clamped']} clamped symbols, stream {stream_bits[i]} bits, "
                f"reference predictor {reference_bits(cfg, fr, dev):.0f} bits")
    ctx.log(f"[decode_ctx] reference {time.perf_counter() - t_ref:.1f} s")
    limit = float(ctx.limits["point_gap"])
    for path in paths:
        os.remove(path)
    os.rmdir(workdir)
    return Outcome(
        end_to_end={"decode_ms": loop.timed_s / n_dec * 1e3, "setup_s": setup_s},
        checks={"point_gap": max(gaps)}, attempted=n_dec, failed=sum(g > limit for g in gaps),
        memory_peak_bytes=peak, obs=obs, busy_s=busy_s, window_s=stretch_s, breakdown=breakdown,
    )
