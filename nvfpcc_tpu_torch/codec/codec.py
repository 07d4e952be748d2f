"""Encode/decode orchestration + the ``pack.pk`` container (port of
``nvfpcc_tpu/codec/codec.py``; every latent mode).

A pack is a pickled dict of three payloads — entropy-packed decoder
weights, octree-coded block origins, range-coded latents — plus the model
metadata that rebuilds the seeded decoder. Packs are byte-compatible with
the JAX package's in both directions. Latent packs by entropy mode:

- channel / spatio: Gaussian tables from the exact f32 ``(sigma, mu)``
  that travel in the pack, per channel or per latent position;
- gmm / factorized: per-channel integer tables that both ends build with
  ``RC.build_cum_tables_gmm`` / ``build_cum_tables_factorized`` from the
  same f32 params the pack carries (:func:`_model_latent_tables`);
- ctx / ctx_ar (format v3): the ctx payload (the masked predictor's kernel
  residual ints and biases), with per-symbol tables that the host's
  integer-exact predictor (``coder/ctx_coder.py``; the decoder's steps
  through ``coder/ctx_steps.py``) derives from the already-coded prefix,
  the same on both ends.

``codec.recon_dtype: "bf16"`` (written only when asked for; absent means
f32) runs the reconstruction on a decoder cast to bfloat16; the occupancy
is upcast to f32 before the threshold compare.

Fidelity gate: the encoder reconstructs from its OWN unpacked weight pack
and the exact integer latents it coded, through the same decoder program
(``reconstruct_points``: fixed batch of 128, zero padding) the decoder runs,
so ``rc_enc == rc_dec`` holds by construction. Across processes on the card
this needs the cuDNN settings of ``device.set_numerics``.
"""

from __future__ import annotations

import itertools
import os
import pickle
import warnings
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from nvfpcc_tpu_torch.codec import weights as W
from nvfpcc_tpu_torch.coder import ctx_coder as CTX
from nvfpcc_tpu_torch.coder import ctx_steps as CTX_STEPS
from nvfpcc_tpu_torch.coder import range_coder as RC
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig
from nvfpcc_tpu_torch.device import set_numerics
from nvfpcc_tpu_torch.models import decoder as M
from nvfpcc_tpu_torch.octree import partition as OT
from nvfpcc_tpu_torch.utils import trace
from nvfpcc_tpu_torch.utils.params import params_from_numpy

PACK_FORMAT_VERSION = 4
_DECODABLE_VERSIONS = (1, 2, 3, 4)
RECON_BATCH = 128
RECON_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
TABLE_MODES = ("gmm", "factorized")  # latent modes coded under per-channel model tables
_DECODES = itertools.count()  # the request of each decode's spans


def encode_origins(origins: np.ndarray, depth: int, level: int) -> dict:
    """Origins payload as trimmed octree occupancy bits (round-trip checked)."""
    s = OT.subtree_occupancy_string(np.asarray(origins, np.int64), depth, level - 1)
    payload = {"mode": "octree", "bits": OT.pack_occupancy_bits(s), "n_bits": len(s)}
    if not np.array_equal(decode_origins(payload, depth, level), np.asarray(origins, np.int64)):
        raise RuntimeError("origins octree round-trip failed")
    return payload


def decode_origins(payload, depth: int, level: int) -> np.ndarray:
    """Inverse of :func:`encode_origins`; also accepts the v1 raw-int16 form."""
    if isinstance(payload, np.ndarray):  # format v1
        return np.asarray(payload, np.int64)
    s = OT.unpack_occupancy_bits(payload["bits"], payload["n_bits"])
    return OT.occupancy_to_origins(s, depth, level, with_leaf_children=False)


@dataclass
class EncodeResult:
    pack: dict
    points: np.ndarray  # reconstructed points (M, 3) int64
    stats: dict  # bpp split etc.


def model_spec(model_cfg: ModelConfig) -> M.ModelSpec:
    return M.build_model_spec(
        model_cfg.ch, model_cfg.channels, model_cfg.seed_tag, model_cfg.entropy_mode,
        ctx_hidden=model_cfg.ctx_hidden, ctx_tail=model_cfg.ctx_tail,
    )


def decoder_from_tree(spec: M.ModelSpec, tree: dict, device, recon_dtype: str = "f32") -> M.CompDecoder:
    """A CompDecoder on ``device`` holding the (decode-minimal) tree's
    weights, cast with its seeded inits to the pack's ``recon_dtype``."""
    if recon_dtype not in RECON_DTYPES:
        raise ValueError(f"unsupported recon_dtype: {recon_dtype!r}")
    dec = params_from_numpy(M.CompDecoder(spec), tree["decoder"], strict=False)
    return dec.to(device, RECON_DTYPES[recon_dtype]).eval()


def _model_latent_tables(mode: str, params: dict, ch: int) -> np.ndarray:
    """Per-channel integer CDF tables of the gmm / factorized latent modes,
    from the exact f32 params that travel in the pack (both ends call this)."""
    if mode == "gmm":
        return RC.build_cum_tables_gmm(params["sigma"], params["mu"], params["p_logit"])
    if mode == "factorized":
        return RC.build_cum_tables_factorized(params, ch)
    raise ValueError(f"unknown latent table mode: {mode}")


@torch.no_grad()
def _recon_chunks(decoder: M.CompDecoder, latents: np.ndarray):
    """(start, occupancy (b, B, B, B) on the device) per fixed-size batch of
    ``RECON_BATCH``; the last batch is zero-padded on both encode and decode.
    The latents go to the device in one copy, so no batch waits for the
    host (a copy from pageable memory waits for the stream)."""
    set_numerics()
    device = decoder.up0.kernel.device
    n = latents.shape[0]
    batch = min(RECON_BATCH, max(n, 1))
    padded = np.zeros((-(-n // batch) * batch,) + latents.shape[1:], np.float32)
    padded[:n] = latents
    padded = torch.as_tensor(padded, device=device)
    for i in range(0, n, batch):
        with trace.span("codec.recon.forward", device=True):
            occ = M.reconstruct(decoder, padded[i : i + batch])[..., 0]
        yield i, occ[: min(batch, n - i)]


def reconstruct_all(decoder: M.CompDecoder, latents: np.ndarray) -> np.ndarray:
    """Occupancy grids (N, B, B, B) float32 of all blocks, on the host."""
    outs = [occ.cpu().numpy() for _, occ in _recon_chunks(decoder, latents)]
    return np.concatenate(outs) if outs else np.zeros((0, 32, 32, 32), np.float32)


def reconstruct_points(
    decoder: M.CompDecoder,
    latents: np.ndarray,
    origins: np.ndarray,
    thh: float,
) -> np.ndarray:
    """Reconstruct + threshold + extract on the device; only the points
    come back, in one copy into one host array. The batches' thresholds
    fill one occupancy mask, so the host waits for the device once, at
    ``torch.nonzero``, which yields ascending flat (C) order: the point
    order of :func:`extract_points` on the full field."""
    with trace.span("codec.recon"):
        n = latents.shape[0]
        if n == 0:
            return np.zeros((0, 3), np.int64)
        device = decoder.up0.kernel.device
        mask = None
        for start, occ in _recon_chunks(decoder, latents):
            with trace.span("codec.recon.extract"):
                if mask is None:
                    mask = torch.empty((n,) + tuple(occ.shape[1:]), dtype=torch.bool, device=device)
                torch.gt(occ, thh, out=mask[start : start + occ.shape[0]])
        idx = torch.nonzero(mask)  # the host's one wait for the batches
        with trace.span("codec.recon.assemble"):
            points = idx[:, 1:] + torch.as_tensor(np.asarray(origins, np.int64), device=device)[idx[:, 0]]
            out = np.empty(tuple(points.shape), np.int64)
            torch.from_numpy(out).copy_(points)
            return out


def extract_points(occ: np.ndarray, origins: np.ndarray, thh: float) -> np.ndarray:
    """Threshold occupancy grids and emit global voxel coordinates: blocks
    in origin order, voxels in C order within a block."""
    idx = np.argwhere(occ > thh)
    if len(idx) == 0:
        return np.zeros((0, 3), np.int64)
    return idx[:, 1:].astype(np.int64) + np.asarray(origins, np.int64)[idx[:, 0]]


def encode(
    params: dict,
    emb: np.ndarray,
    origins: np.ndarray,
    model_cfg: ModelConfig,
    codec_cfg: CodecConfig,
    n_points_src: int,
    device,
) -> EncodeResult:
    """Produce the pack + the encoder-side reconstruction. ``params`` is a
    full numpy params tree (a checkpoint's, JAX layout)."""
    spec = model_spec(model_cfg)
    recon_dtype = codec_cfg.recon_dtype

    # [WEIGHTS] quantize to the 1/qp grid, entropy-pack; the encoder
    # reconstructs from its own unpacked weight pack, as the decoder does
    qparams = W.quantize_residuals(params, codec_cfg.qp)
    net_weight_pack = W.pack_weights(qparams, codec_cfg.qp)
    decoder = decoder_from_tree(spec, W.unpack_weights(net_weight_pack), device, recon_dtype)

    # [LATENTS] integer latents, range coded under the entropy mode's tables
    set_numerics()
    net = params_from_numpy(M.init_params(spec), qparams).to(device)
    with torch.no_grad():
        code = M.get_latent_code(net, torch.as_tensor(np.asarray(emb, np.float32), device=device))
    lat = code["quantized_latent"].cpu().numpy()
    lat_int = np.rint(lat.astype(np.float64)).astype(np.int64)
    if spec.entropy_mode in M.CTX_MODES:
        # context-model path (format v3): per-symbol tables come from the
        # decoded prefix through the integer-exact host predictor, built from
        # the payload exactly as the decoder rebuilds it; a residual clamped
        # to the alphabet is clamped in encoder/decoder lockstep
        ctx_payload = CTX.build_ctx_payload(spec, qparams["entropy"], codec_cfg.qp)
        ctx_ints = CTX.ctx_ints_from_payload(spec, ctx_payload)
        channel_ar = spec.entropy_mode == "ctx_ar"
        with trace.span("codec.encode.ctx"):
            enc = CTX.encode_latents_ctx(lat_int, ctx_ints, channel_ar)
            trace.count(**_ctx_counts(spec.entropy_mode, enc["shape"]), clamped=enc["n_clamped"])
            if enc["n_clamped"]:
                warnings.warn(f"{enc['n_clamped']} ctx latent residual(s) clamped to the alphabet")
            rt = CTX_STEPS.decode_latents_ctx(enc["stream"], enc["shape"], ctx_ints, channel_ar, device)
            if not np.array_equal(rt, enc["coded"]):
                raise RuntimeError("ctx range coder round-trip failed")
        lat_int = enc["coded"]
        latent_pack = {
            "mode": spec.entropy_mode, "stream": enc["stream"], "shape": enc["shape"],
            "ctx": ctx_payload,
        }
        latent_extra_bits = CTX.ctx_payload_bits(ctx_payload)
    else:
        # clamp to the codable alphabet; both sides reconstruct from the
        # clamped ints, so parity is unaffected — but warn, because training
        # drifted
        lo, hi = -RC.OFFSET, RC.N_SYM - RC.OFFSET - 1
        n_out = int(((lat_int < lo) | (lat_int > hi)).sum())
        if n_out:
            warnings.warn(f"{n_out} latent(s) outside the codable range [{lo}, {hi}] were clamped")
            lat_int = np.clip(lat_int, lo, hi)
        if spec.entropy_mode in TABLE_MODES:
            # the tables come from the checkpoint's own f32 leaves, the
            # arrays the pack carries, never from a device copy
            ep = {k: np.asarray(v, np.float32) for k, v in qparams["entropy"].items()}
            cum = _model_latent_tables(spec.entropy_mode, ep, spec.ch)
            latent_pack = {"mode": spec.entropy_mode, "params": ep, **RC.encode_latents_tables(lat_int, cum)}
            latent_extra_bits = 32 * sum(v.size for v in ep.values())
        else:
            latent_pack = RC.encode_latents(
                lat_int, code["sigma"].detach().cpu().numpy(), code["mu"].detach().cpu().numpy()
            )
            latent_extra_bits = 2 * latent_pack["sigma"].size * 32

    # [ORIGINS] trimmed octree occupancy bits
    origins_payload = encode_origins(origins, codec_cfg.depth, codec_cfg.level)

    pack = {
        "format_version": PACK_FORMAT_VERSION,
        "model": {
            "ch": model_cfg.ch,
            "chanstr": model_cfg.chanstr,
            "seed_tag": model_cfg.seed_tag,
            "entropy_mode": model_cfg.entropy_mode,
            # the decoder rebuilds the same predictor width (absent = 8) and
            # tail split (absent = 0, so packs predating ctx_tail decode)
            **({"ctx_hidden": int(spec.ctx_hidden)} if spec.entropy_mode in M.CTX_MODES else {}),
            **({"ctx_tail": int(spec.ctx_tail)}
               if spec.entropy_mode in M.CTX_MODES and spec.ctx_tail else {}),
        },
        "codec": {
            # the decode threshold; the encoder reconstructs at the same value
            "thh": float(codec_cfg.thh_encode),
            "qp": int(codec_cfg.qp),
            "depth": int(codec_cfg.depth),
            "level": int(codec_cfg.level),
            "n_points_src": int(n_points_src),
            # absent = f32, so packs predating the bf16 option decode unchanged
            **({"recon_dtype": "bf16"} if recon_dtype == "bf16" else {}),
        },
        "net_weight_pack": net_weight_pack,
        "origins": origins_payload,
        "latent_pack": latent_pack,
    }

    # encoder-side reconstruction from the exact decode inputs: its own
    # unpacked weight pack and the coded integer latents
    points = reconstruct_points(decoder, lat_int.astype(np.float32), origins, codec_cfg.thh_encode)

    coded_w, as_is_w = W.weight_pack_bits(net_weight_pack)
    if spec.entropy_mode in M.CTX_MODES:
        # the ctx side-information is network weight, as training counts it
        net_bits_total = coded_w + as_is_w + latent_extra_bits
        latent_bits = 8 * len(latent_pack["stream"])
    else:
        net_bits_total = coded_w + as_is_w
        latent_bits = 8 * len(latent_pack["stream"]) + latent_extra_bits
    origin_bits = origins_payload["n_bits"]
    total_bits = net_bits_total + latent_bits + origin_bits
    stats = {
        "n_blocks": int(len(origins)),
        "n_points_src": int(n_points_src),
        "n_points_rec": int(len(points)),
        "b_net": net_bits_total / n_points_src,
        "b_latent": latent_bits / n_points_src,
        "b_origins": origin_bits / n_points_src,
        "bpp": total_bits / n_points_src,
        "latent_stream_bytes": len(latent_pack["stream"]),
        "weight_stream_bytes": len(net_weight_pack["bit_stream"]),
    }
    stats["ctx_payload_bits" if spec.entropy_mode in M.CTX_MODES else "latent_table_bits"] = int(
        latent_extra_bits)
    return EncodeResult(pack=pack, points=points, stats=stats)


def decode(pack: dict, device) -> Tuple[np.ndarray, dict]:
    """Bitstream -> points on ``device``, from the pack alone (seeded decoder
    rebuilt from the model metadata)."""
    if pack.get("format_version") not in _DECODABLE_VERSIONS:
        raise ValueError(f"unsupported pack format: {pack.get('format_version')}")
    with trace.span("codec.decode", request=next(_DECODES)):
        mc = pack["model"]
        spec = model_spec(ModelConfig(
            ch=int(mc["ch"]), chanstr=mc["chanstr"], seed_tag=mc["seed_tag"],
            entropy_mode=mc.get("entropy_mode", "channel"),
            ctx_hidden=int(mc.get("ctx_hidden", M.CTX_HIDDEN)), ctx_tail=int(mc.get("ctx_tail", 0)),
        ))
        recon_dtype = str(pack["codec"].get("recon_dtype", "f32"))
        with trace.span("codec.unpack_weights"):
            tree = W.unpack_weights(pack["net_weight_pack"])
        with trace.span("codec.decoder"):
            decoder = decoder_from_tree(spec, tree, device, recon_dtype)
        with trace.span("codec.latents"):
            latents = decode_latent_pack(spec, pack["latent_pack"], device)
        with trace.span("codec.origins"):
            origins = decode_origins(
                pack["origins"], int(pack["codec"]["depth"]), int(pack["codec"]["level"])
            )
        thh = float(pack["codec"]["thh"])
        points = reconstruct_points(decoder, latents, origins, thh)
    info = {
        "n_blocks": int(len(origins)),
        "n_points_rec": int(len(points)),
        "thh": thh,
        "recon_dtype": recon_dtype,
    }
    return points, info


def _ctx_counts(mode: str, shape) -> dict:
    """What a ctx-mode stream of latents ``shape`` codes: its mode, its
    sequential coding steps (8 positions; times ch in ``ctx_ar``) and its
    symbols."""
    return {"mode": mode, "steps": 8 * int(shape[-1]) if mode == "ctx_ar" else 8,
            "symbols": int(np.prod(shape))}


def decode_latent_pack(spec: M.ModelSpec, latent_pack: dict, device="cpu") -> np.ndarray:
    """The coded integer latents (N, 2, 2, 2, ch) as float32; a ctx
    stream's predictions run on ``device``."""
    mode = latent_pack.get("mode")
    shape = tuple(latent_pack["shape"])
    if mode in M.CTX_MODES:
        with trace.span("codec.latents.ctx"):
            trace.count(**_ctx_counts(mode, shape))
            ctx_ints = CTX.ctx_ints_from_payload(spec, latent_pack["ctx"])
            return CTX_STEPS.decode_latents_ctx(
                latent_pack["stream"], shape, ctx_ints, mode == "ctx_ar", device
            ).astype(np.float32)
    if mode in TABLE_MODES:
        cum = _model_latent_tables(mode, latent_pack["params"], shape[-1])
        return RC.decode_latents_tables(latent_pack["stream"], shape, cum)
    return RC.decode_latents(latent_pack)


def save_pack(path: str, pack: dict) -> int:
    """Pickle the pack; returns the file size in bytes."""
    with open(path, "wb") as f:
        pickle.dump(pack, f, protocol=4)
    return os.path.getsize(path)


class _RestrictedUnpickler(pickle.Unpickler):
    """Admits only the numpy array reconstructors a pack can contain, so a
    hostile pack cannot name an executable global (docs/FORMAT.md §Trust)."""

    _ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
    }

    def find_class(self, module: str, name: str):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"pack.pk may not reference {module}.{name} — refusing to unpickle"
        )


def load_pack(path: str) -> dict:
    """Load a pack with the restricted unpickler."""
    with trace.span("codec.load_pack"), open(path, "rb") as f:
        return _RestrictedUnpickler(f).load()
