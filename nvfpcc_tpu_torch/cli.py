"""Command-line entry point of the port:
``grids | train | encode | decode | eval | weights``.

Flag-compatible with ``python -m nvfpcc_tpu.cli``:

    python -m nvfpcc_tpu_torch.cli grids  cloud.ply --depth 10 --level 5
    python -m nvfpcc_tpu_torch.cli train  cloud.ply --lambda 200 --w1 10 --w2 57 \
        --checkpoint_dir ckpts
    python -m nvfpcc_tpu_torch.cli encode cloud.ply --load_checkpoint ckpts \
        --pack_fn pack.pk --recon rc_enc.ply
    python -m nvfpcc_tpu_torch.cli decode pack.pk --recon rc_dec.ply
    python -m nvfpcc_tpu_torch.cli eval ref.ply rec.ply
    python -m nvfpcc_tpu_torch.cli weights ckpts/0500.npz

``--platform``: ``cpu`` runs everything on the host; ``default`` and
``device`` run on the CUDA card (the EDT kernel included) and fail if there
is none. Checkpoints and packs are the JAX package's formats, so a JAX
checkpoint encodes here and packs decode in either package. ``train`` runs
every entropy mode; ``encode --ctx_post`` fits the context predictor post
hoc; ``encode --recon_dtype bf16`` writes a pack whose reconstruction runs
in bfloat16 on both ends; ``eval --d2`` adds the point-to-plane D2 PSNR.

``train --mesh`` is block-data-parallel training (``nvfpcc_tpu_torch.parallel``):
started alone it runs one rank per visible CUDA device (NCCL), or one rank
with ``--platform cpu`` (gloo); under ``torchrun`` it joins the group the
launcher describes:

    torchrun --nproc_per_node 4 -m nvfpcc_tpu_torch.cli train cloud.ply --mesh
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig, TrainConfig
from nvfpcc_tpu_torch.device import PLATFORMS, resolve_device
from nvfpcc_tpu_torch.io.ply import read_ply_points, write_ply_points

# The helpers from here to ``_DEFAULT_CHANSTR`` are copies of
# ``nvfpcc_tpu/cli.py``'s (the artifact name, the model flags and the auto
# gates decide what a pack holds); ``tests/test_torch_shared_copies.py``
# holds them equal to the originals.


def artifact_path(cloud: str, depth: int, level: int) -> str:
    stem, _ = os.path.splitext(cloud)
    return f"{stem}_d{depth}_l{level}_grids.npz"


def _add_model(p: argparse.ArgumentParser) -> None:
    # ch/chanstr default to None so encode can tell "user said nothing" (fill
    # from the checkpoint metadata) apart from an explicit override
    p.add_argument(
        "--ch", type=int, default=None,
        help="latent channels (default 3; encode reads the checkpoint)",
    )
    p.add_argument(
        "--chanstr", type=str, default=None,
        help="decoder channels (default 8,16,8,8; encode reads the checkpoint)",
    )
    p.add_argument(
        "--entropy_mode",
        choices=("auto", "channel", "spatio", "ctx", "ctx_ar", "gmm", "factorized"),
        default="auto",
        help="latent entropy model: per-channel (sigma,mu); per-position "
        "(spatio); autoregressive masked-conv context prediction (ctx); "
        "ctx plus same-position channel autoregression (ctx_ar); per-channel "
        "2-component Gaussian mixture (gmm); per-channel factorized "
        "logit-CDF MLP (factorized). 'auto' (default) picks the measured "
        "best (RESULTS.md): train chooses per the measured decision table; "
        "encode reads the mode from the checkpoint metadata, upgrading ctx "
        "checkpoints with the post-hoc ctx_ar predictor fit (ctx_post) when "
        "the measured symbol-count break-even predicts a net stream saving",
    )
    p.add_argument(
        "--ctx_detach_pred", action="store_true",
        help="ctx modes: stop the rate gradient at the context predictor's "
        "input (training-time only; latents are then shaped by distortion + "
        "their own rate, not by making later positions predictable)",
    )
    p.add_argument(
        "--ctx_hidden", type=int, default=8,
        help="ctx modes: masked-conv predictor hidden width (8 = reference "
        "PredNet; travels in the pack model metadata)",
    )
    p.add_argument(
        "--ctx_tail", type=int, default=None,
        help="ctx_ar only: how many of the ctx_hidden units are payload-cheap "
        "tail units (full ctx1 receptive field, center-only ctx2 taps — "
        "~1/7 the transmitted taps per unit; travels in the pack model "
        "metadata). Default: the checkpoint's trained value at encode, 0 at "
        "train (every unit full-width)",
    )


def resolve_auto_train(level: int, n_symbols: int) -> str:
    """`--entropy_mode auto` at train time (the JAX package's decision table,
    RESULTS.md round 4): channel dominated the co-trained ctx recipe on all
    three measured vox10 shapes, so channel is the default. ctx is trained
    only where the encode recipe needs a ctx-family checkpoint: at level >= 6
    (vox11-like scales) AND when the break-even economics the encode gate
    uses predict that the ctx_post upgrade pays its predictor payload at
    this cloud's symbol count (:func:`ctx_post_break_even`)."""
    if level >= 6 and ctx_post_break_even(n_symbols)[0] > 0:
        return "ctx"
    return "channel"


# Measured ctx_post economics (results/round5/ctx_capacity2.json: exhaustive
# post-hoc ctx_ar fits with REAL coded bits on the frozen vox11 l200
# ctx-checkpoint latents under the production bf16 recipe, 127,824 symbols,
# marginal 2.2856 b/sym): per (hidden, tail) candidate, the expected
# latent-stream cut in bits/symbol vs the moment-fit marginal and the
# transmitted-predictor payload in bits. h32t24 dominates every other row on
# BOTH axes (largest cut at the smallest payload — the tail units code the
# stream better AND cost ~1/7 the taps), so the gate effectively always
# picks it; the dominated rows stay as measured documentation. The round-3
# f32-recipe table (h8/h16/h32, marginal 3.869, cuts 0.21-0.34 b/sym —
# results/round3/ctx_capacity_sweep.json) is retired: the bf16 trajectory
# lands on far lower-entropy latents and the conditional cuts collapse ~2.5x
# with it (RESULTS.md round 5). Single-cloud provenance: vox11-sphere
# constants used as a break-even model, not re-measured per cloud (a vox11
# torus validation was planned but never landed: results/round5/ holds no
# torus run); explicit --entropy_mode/--ctx_hidden/--ctx_tail flags remain
# authoritative overrides.
CTX_POST_ECONOMICS = (
    # (hidden, tail, expected stream cut b/sym, predictor payload bits)
    (16, 0, 2.2856 - 2.2050, 13_408.0),
    (32, 0, 2.2856 - 2.1904, 22_584.0),
    (32, 16, 2.2856 - 2.1806, 12_896.0),
    (32, 24, 2.2856 - 2.1582, 11_808.0),
)


def ctx_post_break_even(n_symbols: int):
    """(predicted net stream saving in bits, best hidden width, best tail)
    for a post-hoc ctx_ar upgrade of an n_symbols-latent pack. The saving
    model is ``n_symbols * cut(h,t) - payload(h,t)`` over the measured
    economics table; a non-positive best saving means the predictor payload
    would cancel the stream gain (the measured vox10 outcome, RESULTS.md
    E4). With the round-5 table the break-even edge is h32t24's
    ~93k symbols."""
    return max(
        (n_symbols * cut - payload, h, t)
        for h, t, cut, payload in CTX_POST_ECONOMICS
    )


def resolve_auto_encode(trained_mode: str, trained_hidden: int, n_symbols: int):
    """`--entropy_mode auto` at encode time -> (entropy_mode, ctx_hidden,
    ctx_tail, ctx_post). A ctx-family checkpoint is upgraded with the
    post-hoc fitted channel-AR predictor when the measured break-even model
    predicts a net stream saving at this cloud's symbol count
    (:func:`ctx_post_break_even` — the quantity that actually decides the
    trade; the round-3 ``level >= 6`` gate was a proxy for it and
    misclassified small-but-deep or large-but-shallow clouds). Measured
    anchors (round-5 table): vox11 sphere (127,824 symbols) predicts +4.5k
    bits at h32t24 and measured +4.7k vs the marginal floor
    (results/round5/ctx_capacity2.json); vox10 sphere (23,136 symbols)
    predicts negative and measured canceled (E4). Channel-trained latents
    are measured conditionally unpredictable (RESULTS.md round 3), so only
    ctx-family checkpoints upgrade."""
    if trained_mode in ("ctx", "ctx_ar"):
        gain, hidden, tail = ctx_post_break_even(n_symbols)
        if gain > 0:
            return "ctx_ar", hidden, tail, True
    return trained_mode, trained_hidden, 0, False


_DEFAULT_CH = 3
_DEFAULT_CHANSTR = "8,16,8,8"


def _model_cfg(args) -> ModelConfig:
    return ModelConfig(
        ch=args.ch if args.ch is not None else _DEFAULT_CH,
        chanstr=args.chanstr if args.chanstr is not None else _DEFAULT_CHANSTR,
        entropy_mode=args.entropy_mode,
        ctx_detach_pred=args.ctx_detach_pred,
        ctx_hidden=args.ctx_hidden,
        ctx_tail=args.ctx_tail or 0,
        ctx_train_init=getattr(args, "ctx_train_init", "zero"),
    )


def resolve_encode_flags(args, meta: dict, n_blocks: int) -> str:
    """Fill the encode's entropy flags from the checkpoint and ``auto``, the
    way ``nvfpcc_tpu/cli.py`` does, so one command line makes the same pack
    in both packages; returns the line to print. An unset ``--ctx_tail``
    takes the checkpoint's trained split. ``auto`` takes the checkpoint's
    mode and, where the break-even model predicts a saving, upgrades a ctx
    checkpoint to ctx_ar + ctx_post at the model's best (hidden, tail). An
    explicit ``--ctx_post`` with ``auto`` keeps the tail it had (the
    checkpoint's or the flag's), as the JAX package does."""
    if args.ctx_tail is None:
        # a co-trained tail split is part of the trained predictor; ctx_post
        # refits from scratch, so the auto economics may still replace it
        args.ctx_tail = int(meta.get("ctx_tail", 0))
    if args.entropy_mode != "auto":
        return ""
    trained = str(meta.get("entropy_mode", "channel"))
    n_symbols = n_blocks * int(args.ch) * 8  # the latent symbols this pack codes
    mode, hidden, tail, post = resolve_auto_encode(
        trained, int(meta.get("ctx_hidden", args.ctx_hidden)), n_symbols
    )
    args.entropy_mode, args.ctx_hidden = mode, hidden
    if post:
        gain = ctx_post_break_even(n_symbols)[0]
        if not args.ctx_post:
            args.ctx_post, args.ctx_tail = True, tail
            why = "pass an explicit --entropy_mode to opt out"
        else:
            why = f"the explicit --ctx_post keeps tail {args.ctx_tail}"
        return (f"[encode] entropy_mode auto -> ctx_ar + ctx_post (hidden {hidden} tail "
                f"{args.ctx_tail}): predicted net stream saving {gain:.0f} bits at {n_symbols} "
                f"symbols (measured break-even model); {why}")
    if trained in ("ctx", "ctx_ar"):
        return (f"[encode] entropy_mode auto -> {mode} (from checkpoint; ctx_post break-even "
                f"not met at {n_symbols} symbols)")
    return f"[encode] entropy_mode auto -> {mode} (from checkpoint)"


def load_or_build_artifacts(cloud: str, depth: int, level: int, device, log=print) -> dict:
    """origins/gt/dist for a cloud, cached as one npz beside it (the same
    file name and layout as the JAX CLI's)."""
    from nvfpcc_tpu_torch.grids.builder import build_artifacts

    path = artifact_path(cloud, depth, level)
    if os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(cloud):
        with np.load(path) as data:
            return {k: data[k] for k in ("origins", "gt", "dist")}
    t0 = time.time()
    points = np.rint(read_ply_points(cloud)).astype(np.int64)
    if points.min() < 0 or points.max() >= (1 << depth):
        raise SystemExit(f"cloud exceeds the 2^{depth} cube: [{points.min()}, {points.max()}]")
    origins, gt, dist = build_artifacts(points, depth, level, device=device)
    np.savez_compressed(path, origins=origins, gt=gt, dist=dist)
    log(
        f"[grids] {len(points)} pts -> {len(origins)} blocks of "
        f"{1 << (depth - level)}^3 on {device} in {time.time() - t0:.1f}s -> {path}"
    )
    return {"origins": origins, "gt": gt, "dist": dist}


def _add_platform(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--platform", choices=PLATFORMS, default="default",
        help="cpu: run on the host; default/device: run on the CUDA card "
        "(the EDT kernel included) and fail if there is none",
    )


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--depth", type=int, default=10, help="voxel depth (vox10 -> 10)")
    p.add_argument("--level", type=int, default=5, help="octree partition level")
    _add_platform(p)


def cmd_grids(args) -> int:
    load_or_build_artifacts(args.cloud, args.depth, args.level, resolve_device(args.platform))
    return 0


def cmd_train(args) -> int:
    from nvfpcc_tpu_torch.parallel import mesh as pm

    if args.mesh and pm.under_torchrun():
        mesh = pm.init_distributed("cpu" if args.platform == "cpu" else "cuda")
        try:
            return _train(args, mesh.device, mesh)
        finally:
            torch.distributed.destroy_process_group()
    return _train(args, resolve_device(args.platform), None)


def _train(args, device, mesh) -> int:
    """``train`` in one process, as one rank of a torchrun group (``mesh``),
    or, with ``--mesh`` started alone, over a group of its own."""
    from nvfpcc_tpu_torch.parallel import mesh as pm
    from nvfpcc_tpu_torch.train.loop import train, train_on_mesh

    # under torchrun rank 0 builds the grids if they are not cached; the
    # other ranks wait for it, then read them
    if mesh is not None and mesh.rank:
        torch.distributed.barrier()
    art = load_or_build_artifacts(args.cloud, args.depth, args.level, device)
    if mesh is not None and not mesh.rank:
        torch.distributed.barrier()
    job = train_job(args, art, print if mesh is None or not mesh.rank else (lambda line: None))
    if not args.mesh:
        gt, dist, mcfg, cfg = (job.pop(k) for k in ("gt", "dist", "model_cfg", "cfg"))
        train(gt, dist, mcfg, cfg, device, **job)
        return 0
    if mesh is not None:  # a rank that torchrun started
        if not mesh.rank:
            print(f"[train] block-DP mesh over {mesh.world} devices", flush=True)
        train_on_mesh(mesh, [job], echo=True)
        return 0
    # started alone: one rank per visible CUDA device, one on the CPU
    world = 1 if device.type == "cpu" else torch.cuda.device_count()
    print(f"[train] block-DP mesh over {world} devices", flush=True)
    devices = ["cpu"] if device.type == "cpu" else [f"cuda:{r}" for r in range(world)]
    pm.run_group(train_on_mesh, world, "gloo" if device.type == "cpu" else "nccl", devices,
                 args=([job],), kwargs={"echo": True})
    return 0


def train_job(args, art: dict, log=print) -> dict:
    """``train``'s keyword arguments for parsed ``train`` flags and a cloud's
    grids (a job of ``train.loop.train_on_mesh``): the grids, the model and
    training configs (``--entropy_mode auto`` resolved here, with a line to
    ``log``) and the output paths."""
    ch = args.ch if args.ch is not None else _DEFAULT_CH
    if args.entropy_mode == "auto":
        args.entropy_mode = resolve_auto_train(args.level, len(art["origins"]) * ch * 8)
        log(
            f"[train] entropy_mode auto -> {args.entropy_mode} (channel unless the level is >= 6 "
            "and the ctx_post upgrade pays at this symbol count)"
        )
    cfg = TrainConfig(
        lmbda=args.lmbda, w1=args.w1, w2=args.w2, wemb=args.wemb, lr=args.lr,
        batch_size=args.batchsize, epochs=args.epochs, phase_change=args.phase_change,
        shuffle=args.shuffle, eval_every=args.eval_every, compute_dtype=args.compute_dtype,
        emb_chunks=args.emb_chunks, seed=args.seed,
    )
    return dict(gt=art["gt"], dist=art["dist"], model_cfg=_model_cfg(args), cfg=cfg,
                checkpoint_dir=args.checkpoint_dir, resume=args.resume, metrics_path=args.metrics,
                profile_dir=args.profile)


def _load_train_state(args, n_blocks: int):
    from nvfpcc_tpu_torch.utils import checkpoint as C

    path = args.load_checkpoint
    if os.path.isdir(path):
        path = C.latest_checkpoint(path)
        if path is None:
            raise SystemExit(f"no checkpoints in {args.load_checkpoint}")
    params, emb, meta = C.load_checkpoint_meta(path)
    if emb is None:
        raise SystemExit(f"checkpoint {path} has no embeddings")
    if emb.shape[0] != n_blocks:
        raise SystemExit(
            f"checkpoint {path} has {emb.shape[0]} embedding rows but the cloud "
            f"partitions into {n_blocks} blocks — depth/level or artifact "
            "mismatch with the training run"
        )
    return params, emb, meta or {}


def cmd_encode(args) -> int:
    from nvfpcc_tpu_torch import codec

    device = resolve_device(args.platform)
    art = load_or_build_artifacts(args.cloud, args.depth, args.level, device)
    n_blocks = len(art["origins"])
    n_points = int(art["gt"].sum())
    params, emb, meta = _load_train_state(args, n_blocks)
    # unstated model-size flags come from the checkpoint metadata; explicit
    # ones must agree with it
    for flag, default in (("ch", _DEFAULT_CH), ("chanstr", _DEFAULT_CHANSTR)):
        trained_v, given_v = meta.get(flag), getattr(args, flag)
        if given_v is None:
            setattr(args, flag, trained_v if trained_v is not None else default)
        elif trained_v is not None and str(given_v) != str(trained_v):
            raise SystemExit(
                f"--{flag} {given_v} contradicts the checkpoint (trained with "
                f"--{flag} {trained_v}); drop the flag to use the trained value"
            )
    line = resolve_encode_flags(args, meta, n_blocks)
    if line:
        print(line)
    args.ch, args.chanstr = int(args.ch), str(args.chanstr)
    mcfg = _model_cfg(args)
    if args.ctx_post:
        # post-hoc predictor fit: entropy-upgrade the checkpoint to a ctx /
        # ctx_ar pack without touching its latents (same reconstruction)
        from nvfpcc_tpu_torch.train.ctx_fit import upgrade_params_to_ctx

        if mcfg.entropy_mode not in ("ctx", "ctx_ar"):
            raise SystemExit(
                "--ctx_post needs --entropy_mode ctx or ctx_ar (it fits the masked-conv "
                "predictor the pack will carry)"
            )
        fit_device = torch.device("cpu") if args.ctx_fit_backend == "cpu" else device
        t0 = time.time()
        params = upgrade_params_to_ctx(
            codec.model_spec(mcfg), params, np.asarray(emb), fit_device, steps=args.ctx_fit_steps,
            lr=args.ctx_fit_lr, early_stop=args.ctx_fit_early_stop,
        )
        print(f"[encode] ctx_post fit on {fit_device} in {time.time() - t0:.1f}s")
    ccfg = CodecConfig(
        thh_encode=args.thh, thh_decode=args.thh, qp=args.qp,
        depth=args.depth, level=args.level, recon_dtype=args.recon_dtype,
    )
    result = codec.encode(params, emb, art["origins"], mcfg, ccfg, n_points, device)
    size = codec.save_pack(args.pack_fn, result.pack)
    s = result.stats
    print(
        f"[encode] {s['n_blocks']} blocks, {s['n_points_src']} pts -> "
        f"{size} B pack | bpp {s['bpp']:.4f} "
        f"(latent {s['b_latent']:.4f} net {s['b_net']:.4f} origins {s['b_origins']:.4f}) "
        f"| recon {s['n_points_rec']} pts"
        + (f" | ctx payload {s['ctx_payload_bits']} bits" if "ctx_payload_bits" in s
           else f" | latent tables {s['latent_table_bits']} bits")
    )
    if args.recon:
        write_ply_points(args.recon, result.points, ascii=False)
        print(f"[encode] wrote {args.recon}")
    return 0


def cmd_decode(args) -> int:
    from nvfpcc_tpu_torch import codec

    device = resolve_device(args.platform)
    pack = codec.load_pack(args.pack)
    if args.thh is not None:
        pack["codec"]["thh"] = args.thh
    t0 = time.time()
    points, info = codec.decode(pack, device)
    print(
        f"[decode] {info['n_blocks']} blocks -> {info['n_points_rec']} pts "
        f"@ thh {info['thh']} in {time.time() - t0:.1f}s"
    )
    if args.recon:
        write_ply_points(args.recon, points, ascii=False)
        print(f"[decode] wrote {args.recon}")
    return 0


def cmd_eval(args) -> int:
    """D1 (and with ``--d2`` point-to-plane D2) PSNR between two point clouds."""
    from nvfpcc_tpu_torch.metrics import d1_psnr, d2_psnr

    device = resolve_device(args.platform)
    ref = np.rint(read_ply_points(args.ref)).astype(np.int64)
    rec = np.rint(read_ply_points(args.rec)).astype(np.int64)
    m = d1_psnr(ref, rec, depth=args.depth, device=device)
    print(
        f"[eval] D1 PSNR {m['psnr']:.4f} dB | mse(ref->rec) {m['mse_ab']:.6f} "
        f"mse(rec->ref) {m['mse_ba']:.6f} | {len(ref)} vs {len(rec)} pts"
    )
    if args.d2:
        m2 = d2_psnr(ref, rec, depth=args.depth, device=device)
        print(
            f"[eval] D2 PSNR {m2['psnr']:.4f} dB | p2plane mse(ref->rec) "
            f"{m2['mse_ab']:.6f} mse(rec->ref) {m2['mse_ba']:.6f}"
        )
        print(
            f"[eval] D2 seconds: normals {m2['normals_s']:.2f}, nearest-neighbour "
            f"vectors {m2['nn_s']:.2f} (EDT {m2['edt_s']:.2f})"
        )
    return 0


def cmd_weights(args) -> int:
    """Standalone weight quantize + entropy-pack report: quantize a
    checkpoint to the 1/qp grid, pack, verify lossless, report bits."""
    from nvfpcc_tpu_torch.codec import weights as W
    from nvfpcc_tpu_torch.utils import checkpoint as C
    from nvfpcc_tpu_torch.utils.params import flatten_tree

    params, emb = C.load_checkpoint(args.ckpt)
    qparams = W.quantize_residuals(params, args.qp)
    pack = W.pack_weights(qparams, args.qp)
    coded, as_is = W.weight_pack_bits(pack)
    n_coded = pack["element_length"]
    print(
        f"[weights] {n_coded} residuals @ 1/{args.qp} -> {coded} bits coded "
        f"({coded / n_coded:.3f} b/residual) + {as_is} bits as-is fp32 "
        f"| lossless round-trip OK"
    )
    if args.out:
        d = os.path.dirname(args.out)
        if d:
            os.makedirs(d, exist_ok=True)
        np.savez(
            args.out, **flatten_tree(qparams),
            **({"__emb__": np.asarray(emb)} if emb is not None else {}),
        )
        print(f"[weights] wrote quantized checkpoint {args.out}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="nvfpcc_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("grids", help="build origins + occupancy/distance grids")
    g.add_argument("cloud")
    _add_common(g)
    g.set_defaults(fn=cmd_grids)

    t = sub.add_parser("train", help="overfit the codec to one cloud")
    t.add_argument("cloud")
    _add_common(t)
    _add_model(t)
    t.add_argument("--lambda", dest="lmbda", type=float, default=200.0)
    t.add_argument("--w1", type=float, default=10.0)
    t.add_argument("--w2", type=float, default=57.0)
    t.add_argument("--wemb", type=float, default=5.0)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--batchsize", type=int, default=16)
    t.add_argument("--epochs", type=int, default=501)
    t.add_argument("--phase_change", type=int, default=100)
    t.add_argument("--shuffle", choices=("stride", "random", "none"), default="stride")
    t.add_argument("--eval_every", type=int, default=10)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--checkpoint_dir", type=str, default="ckpts")
    t.add_argument("--mesh", action="store_true", help="block-DP over all devices")
    t.add_argument(
        "--resume", action="store_true",
        help="resume from the latest full train-state snapshot in checkpoint_dir",
    )
    t.add_argument(
        "--metrics", type=str, default=None,
        help="append one JSON line of metrics per epoch to this file",
    )
    t.add_argument(
        "--profile", type=str, default=None,
        help="write a torch.profiler trace of epochs 3-5 to this dir",
    )
    t.add_argument(
        "--ctx_train_init", choices=("zero", "feature"), default="zero",
        help="ctx modes: predictor init for co-training. zero = reference "
        "behavior, the measured RD default; feature = working-predictor "
        "init, measured worse for co-training, kept selectable",
    )
    t.add_argument(
        "--compute_dtype", choices=("f32", "bf16"), default="bf16",
        help="decoder-conv arithmetic precision during training (bf16 default "
        "= mixed precision; master params / rate / loss stay f32; "
        "--compute_dtype f32 restores the reference-exact recipe)",
    )
    t.add_argument(
        "--emb_chunks", type=int, default=0,
        help="full-set embedding-update block chunking; 0 = auto (one chunk "
        "up to 4096 blocks, then the smallest count that keeps each chunk "
        "at or under 4096)",
    )
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("encode", help="pack weights+latents+origins -> pack.pk")
    e.add_argument("cloud")
    _add_common(e)
    _add_model(e)
    e.add_argument("--load_checkpoint", required=True, help="ckpt file or dir")
    e.add_argument("--pack_fn", type=str, default="pack.pk")
    e.add_argument("--recon", type=str, default=None, help="write rc_enc.ply here")
    e.add_argument("--thh", type=float, default=0.65)
    e.add_argument("--qp", type=int, default=16)
    e.add_argument(
        "--recon_dtype", choices=("f32", "bf16"), default="f32",
        help="reconstruction dtype; bf16 runs the decode chain in bfloat16 (rides in "
        "the pack, so both ends run it)",
    )
    e.add_argument(
        "--ctx_post", action="store_true",
        help="fit the ctx/ctx_ar predictor post hoc on the checkpoint's frozen "
        "latents before packing (same reconstruction and D1, smaller latent stream)",
    )
    e.add_argument("--ctx_fit_steps", type=int, default=3000)
    e.add_argument("--ctx_fit_lr", type=float, default=3e-2)
    e.add_argument(
        "--ctx_fit_early_stop", type=float, default=2e-3,
        help="end a ctx_post fit phase when a 250-step chunk improves the "
        "stream-bit estimate by less than this fraction (0 disables)",
    )
    e.add_argument(
        "--ctx_fit_backend", choices=("", "cpu"), default="",
        help="device of the ctx_post fit: empty = the device the encode runs on "
        "(the card unless --platform cpu), cpu = the host; any result is a valid pack",
    )
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="pack.pk -> reconstructed cloud")
    d.add_argument("pack")
    d.add_argument("--recon", type=str, default="rc_dec.ply")
    d.add_argument("--thh", type=float, default=None, help="override pack threshold")
    _add_platform(d)
    d.set_defaults(fn=cmd_decode)

    ev = sub.add_parser("eval", help="D1 (and optional D2) PSNR between two .ply clouds")
    ev.add_argument("ref")
    ev.add_argument("rec")
    ev.add_argument(
        "--d2", action="store_true",
        help="also report point-to-plane D2 PSNR (PCA normals over a radius-2 window)",
    )
    _add_common(ev)
    ev.set_defaults(fn=cmd_eval)

    wt = sub.add_parser(
        "weights", help="quantize + entropy-pack a checkpoint's weights (report bits)"
    )
    wt.add_argument("ckpt")
    wt.add_argument("--out", type=str, default=None, help="write quantized ckpt here")
    wt.add_argument("--qp", type=int, default=16)
    wt.set_defaults(fn=cmd_weights)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
