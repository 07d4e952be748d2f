"""Host coder for the autoregressive latent context model (pack format v3).

Copy of ``nvfpcc_tpu/coder/ctx_coder.py`` (the payload, the integer
predictor and the streams are a pack-format contract;
``tests/test_torch_shared_copies.py`` holds the two byte-equal).

Capability rebuild of the reference's dormant masked-conv context stack
(the reference's ``utils/network.py:4312-4465``: ``QMaskedConv3d`` /
``PredNet`` / ``CtxPredLikelihoodModel``): per-position (mu, sigma) of each
latent symbol is predicted from the causally-prior positions of the SAME
block (raster order over the 2x2x2 latent grid), and the symbol is
range-coded under a Gaussian with those parameters. Training runs the same
predictor teacher-forced in one parallel masked-conv pass on device
(``models/decoder.py:CtxPredictor``); only 8 positions exist per block, so
decode is 8 sequential steps, each decoding all (block, channel) symbols of
one position at once.

Determinism design (the v3 extension of the repo's "no float near the
bitstream" rule): the prediction both sides evaluate is INTEGER-EXACT —

- transmitted kernel residuals are ints on the 1/16 grid; the seeded inits
  are rounded once to the 1/KSCALE grid (``rint(init*KSCALE)``, exact in f64
  from the f32 init); the effective kernel is a (k,k,k,cin,cout) int64 at
  scale KSCALE, zero outside the causal mask,
- biases are ints at scale KSCALE (``rint((b_res + b_init)*KSCALE)``),
- the two conv layers accumulate in int64 (numpy integer einsum — no BLAS,
  no float); the leaky-relu (slope 1/16) floors negative values
  (``h // 16``), and mu is rounded to the 1/16 grid with a fixed integer
  rule, so encoder and decoder compute bit-identical (mu, sigma) regardless
  of platform or accumulation order.
- sigma is bucketed to 256 log-spaced levels; the per-symbol CDF table is
  keyed by ``(sigma_level, mu_frac16)`` — at most 4096 distinct tables,
  built lazily for the keys that actually occur. mu's integer part shifts
  the symbol instead of the table.

The only remaining float is the one the whole format already carries: the
Gaussian->integer-table build (float64 ``erf``), evaluated from *quantized*
(sigma, mu) by the identical host function on both ends (docs/FORMAT.md).

The mismatch between the float training-time predictor (f32 inits, exact
1/16 leaky slope) and this fixed-point coding-time predictor costs a little
rate optimality, never parity — like weight quantization itself.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from nvfpcc_tpu_torch.coder import range_coder as RC

KSCALE = 4096  # kernel + bias fixed-point scale (2^12)
# Precision/overflow budget: |latent| < 2^9, <=39 taps/layer -> layer-1
# accumulators < 2^9 * 39 * |K|*2^12 ~ 2^27*|K|; layer-2 < 104 * that * 2^12
# ~ 2^46*|K|^2 — int64-safe up to |kernel| ~ 2^5, far beyond trained values.
# Init rounding error 2^-13 per tap keeps the fixed-point prediction within
# ~0.3% of the float predictor (tested in tests/test_ctx.py).
OUT2_SCALE = KSCALE * KSCALE  # layer-2 accumulator scale
MU_GRID = 16  # mu quantized to the 1/16 grid
SIGMA_LEVELS = 256
LOG2_SIGMA_MIN = -6.0  # sigma level i = 2^(LOG2_SIGMA_MIN + i/16)
LEVELS_PER_OCTAVE = 16

# raster-causal 3x3x3 tap offsets (13 strictly-before taps + the center):
# matches ops.conv.causal_mask / channel_ar_mask — the center tap's weights
# are zero in plain "ctx" mode (masked out of K_int) and channel-gated in
# "ctx_ar" mode, so one generic offset loop serves both
_CAUSAL_OFFSETS = [
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
    if (dz, dy, dx) <= (0, 0, 0)
]

# sigma quantization: level boundaries in the scale-OUT2_SCALE integer domain
_SIGMA_VALS = np.float32(
    2.0 ** (LOG2_SIGMA_MIN + np.arange(SIGMA_LEVELS, dtype=np.float64) / LEVELS_PER_OCTAVE)
)
_SIGMA_BOUNDS = np.rint(
    OUT2_SCALE
    * 2.0
    ** (LOG2_SIGMA_MIN + (np.arange(SIGMA_LEVELS - 1, dtype=np.float64) + 0.5) / LEVELS_PER_OCTAVE)
).astype(np.int64)

_RASTER = [(p >> 2 & 1, p >> 1 & 1, p & 1) for p in range(8)]  # (z, y, x) C-order

_MU_DIV = OUT2_SCALE // MU_GRID  # 4096: scale-OUT2 value -> 1/16-grid integer
_MU_SHIFT = _MU_DIV.bit_length() - 1


def ctx_ints_from_payload(spec, payload: dict) -> Dict[str, np.ndarray]:
    """Integer kernels/biases for the exact predictor, reconstructed from the
    transmitted ctx payload + the spec's regenerable seeded inits. The
    ENCODER derives its ints through this same function on its own payload,
    so both sides predict from bit-identical integers by construction."""
    from nvfpcc_tpu_torch.codec.weights import unpack_int_stream
    from nvfpcc_tpu_torch.models.decoder import CTX_KERNELS

    res_flat = unpack_int_stream(payload["res"], int(payload["res"]["element_length"]))
    qp = int(payload.get("qp", 16))  # residual grid; absent in older v3 packs
    if qp <= 0 or KSCALE % qp != 0:
        raise ValueError(f"ctx payload qp={qp} must divide KSCALE={KSCALE}")
    ints: Dict[str, np.ndarray] = {}
    off = 0
    for i, name in enumerate(CTX_KERNELS, start=1):
        s = spec.specs[name]
        idx = s.mask_flat_indices
        res_int = np.zeros(int(np.prod(s.kernel_shape)), np.int64)
        res_int[idx] = res_flat[off : off + len(idx)]
        off += len(idx)
        init256 = np.rint(np.asarray(s.kernel_init, np.float64) * KSCALE).astype(np.int64)
        k_int = res_int.reshape(s.kernel_shape) * (KSCALE // qp) + init256
        k_int *= np.broadcast_to(s.mask, s.kernel_shape).astype(np.int64)
        b_res = np.asarray(payload["bias"][name], np.float64)
        b_init = np.asarray(s.b_init, np.float64)
        ints[f"K{i}"] = k_int
        ints[f"b{i}"] = np.rint((b_res + b_init) * KSCALE).astype(np.int64)
    assert off == len(res_flat), "ctx residual stream length mismatch"
    return ints


def build_ctx_payload(spec, entropy_params: dict, qp: int = 16) -> dict:
    """Transmitted ctx payload from (quantized) entropy params: the masked
    kernel residual ints on the 1/qp grid, range-coded under their empirical
    histogram, plus the fp32 residual biases (inits regenerate from the seed
    stream). ``qp`` must divide KSCALE (4096) so the fixed-point predictor
    stays exact; it travels in the payload for the decoder."""
    from nvfpcc_tpu_torch.codec.weights import pack_int_stream
    from nvfpcc_tpu_torch.models.decoder import CTX_KERNELS

    if qp <= 0 or KSCALE % qp != 0:
        raise ValueError(
            f"ctx modes need a qp dividing {KSCALE} (got {qp}) — the exact "
            "integer predictor represents residuals at scale KSCALE/qp"
        )
    res_parts = []
    bias = {}
    for name in CTX_KERNELS:
        s = spec.specs[name]
        k = np.asarray(entropy_params[name]["kernel"], np.float64).reshape(-1)
        idx = s.mask_flat_indices
        ri = np.rint(k[idx] * qp)
        if not np.allclose(k[idx] * qp, ri, atol=1e-4):
            raise ValueError(
                f"ctx kernel '{name}' is not on the 1/{qp} grid — "
                "run quantize_residuals with the same qp first"
            )
        res_parts.append(ri.astype(np.int64))
        bias[name] = np.asarray(entropy_params[name]["b"], np.float32)
    flat = np.concatenate(res_parts)
    res = pack_int_stream(flat)
    res["element_length"] = int(len(flat))
    return {"res": res, "bias": bias, "qp": int(qp)}


def ctx_payload_bits(payload: dict) -> int:
    """Transmitted size of the ctx side-information (counts toward b_net)."""
    from nvfpcc_tpu_torch.codec.weights import int_stream_bits

    bias_bits = 32 * sum(int(np.asarray(b).size) for b in payload["bias"].values())
    return int_stream_bits(payload["res"]) + bias_bits


def _masked_conv_int(x_int: np.ndarray, k_int: np.ndarray, b_int: np.ndarray, x_scale: int):
    """Exact int64 causal conv on the (N,2,2,2,Cin) latent grid, 'same'
    padding. Output scale = x_scale * KSCALE."""
    n, cin = x_int.shape[0], x_int.shape[-1]
    assert k_int.shape[3] == cin
    xp = np.zeros((n, 4, 4, 4, cin), np.int64)
    xp[:, 1:3, 1:3, 1:3, :] = x_int
    out = np.zeros((n, 2, 2, 2, k_int.shape[4]), np.int64)
    for dz, dy, dx in _CAUSAL_OFFSETS:
        w = k_int[dz + 1, dy + 1, dx + 1]  # (cin, cout)
        xs = xp[:, 1 + dz : 3 + dz, 1 + dy : 3 + dy, 1 + dx : 3 + dx, :]
        out += np.einsum("nzyxc,co->nzyxo", xs, w)
    return out + b_int * x_scale


def _pred_outputs(out: np.ndarray):
    """(mu16, sigma_idx) from the scale-OUT2_SCALE layer-2 integers."""
    ch = out.shape[-1] // 2
    mu_s = out[..., :ch]
    sg_s = np.abs(out[..., ch:])
    mu16 = (mu_s + _MU_DIV // 2) >> _MU_SHIFT  # round to 1/16 grid (half-up)
    sidx = np.searchsorted(_SIGMA_BOUNDS, sg_s.reshape(-1), side="right")
    return mu16, sidx.reshape(sg_s.shape).astype(np.int64)


def predict_int(x_int: np.ndarray, ints: Dict[str, np.ndarray]):
    """(mu16, sigma_idx) for every (block, position, channel).

    ``mu16``: int64, mu on the 1/16 grid (value = mu16/16).
    ``sigma_idx``: int64 in [0, 256) -> sigma = _SIGMA_VALS[idx].
    Fully deterministic integer arithmetic (see module docstring). This is
    the reference int64 implementation; the coding loops use
    :class:`ExactPredictor`, which computes the identical integers faster."""
    h = _masked_conv_int(x_int, ints["K1"], ints["b1"], 1)  # scale KSCALE
    h = np.where(h >= 0, h, h // MU_GRID)  # leaky slope 1/16, floored
    out = _masked_conv_int(h, ints["K2"], ints["b2"], KSCALE)  # scale OUT2_SCALE
    return _pred_outputs(out)


def _dense_from_kernel(k_int: np.ndarray) -> np.ndarray:
    """(3,3,3,cin,cout) tap kernel -> dense (8*cin, 8*cout) int64 matrix over
    the flattened 2x2x2 grid (positions in raster order, channel-minor):
    ``W[q*cin+ci, p*cout+co] = K[(q-p)+1, ci, co]`` for |q-p| taps within the
    3^3 window (masked taps are already zero in ``k_int``, so causality is
    inherited). One matmul then replaces the 14-offset shift-and-accumulate."""
    cin, cout = int(k_int.shape[3]), int(k_int.shape[4])
    w = np.zeros((8 * cin, 8 * cout), np.int64)
    for pi, (pz, py, px) in enumerate(_RASTER):
        for qi, (qz, qy, qx) in enumerate(_RASTER):
            dz, dy, dx = qz - pz, qy - py, qx - px
            if max(abs(dz), abs(dy), abs(dx)) <= 1:
                w[qi * cin : (qi + 1) * cin, pi * cout : (pi + 1) * cout] = k_int[
                    dz + 1, dy + 1, dx + 1
                ]
    return w


class ExactPredictor:
    """Fast exact predictor: the two masked convs as dense block matrices.

    Produces bit-identical integers to :func:`predict_int` (asserted in
    tests). When a rigorous magnitude bound shows every product and partial
    sum stays below 2^53, the matmuls run in float64 BLAS — float64 adds and
    multiplies of integers in that range are EXACT and order-independent, so
    determinism is preserved while gaining ~30x over numpy's int64 einsum
    (the hot path of autoregressive decode: 8 or 8*ch sequential predicts).
    Inputs exceeding the bound (absurd kernels/latents) fall back to the
    int64 path automatically.
    """

    def __init__(self, ints: Dict[str, np.ndarray]):
        self._ints = ints
        self._w1 = _dense_from_kernel(ints["K1"])
        self._w2 = _dense_from_kernel(ints["K2"])
        self._w1f = self._w1.astype(np.float64)
        self._w2f = self._w2.astype(np.float64)
        self._b1f = np.tile(np.asarray(ints["b1"], np.int64), 8).astype(np.float64)
        self._b2f = np.tile(np.asarray(ints["b2"], np.int64), 8).astype(
            np.float64
        ) * float(KSCALE)
        self._colsum1 = int(np.abs(self._w1).sum(axis=0).max(initial=0))
        self._colsum2 = int(np.abs(self._w2).sum(axis=0).max(initial=0))
        self._b1max = int(np.abs(ints["b1"]).max(initial=0))
        self._b2max = int(np.abs(ints["b2"]).max(initial=0)) * KSCALE
        self._cout = int(ints["K2"].shape[4])

    def __call__(self, x_int: np.ndarray):
        n = x_int.shape[0]
        xmax = int(np.abs(x_int).max(initial=0))
        bound1 = xmax * self._colsum1 + self._b1max
        bound2 = bound1 * self._colsum2 + self._b2max
        if max(bound1, bound2) < (1 << 53):
            xf = np.ascontiguousarray(x_int.reshape(n, -1), np.float64)
            pre1 = xf @ self._w1f + self._b1f
            # leaky slope 1/16: floor(pre/16) for negatives; pre/16 is exact
            # (power-of-two divide), floor of an exact value is exact
            h = np.where(pre1 >= 0, pre1, np.floor(pre1 * (1.0 / MU_GRID)))
            pre2 = h @ self._w2f + self._b2f
            out = pre2.astype(np.int64).reshape(n, 2, 2, 2, self._cout)
            return _pred_outputs(out)
        return predict_int(x_int, self._ints)


def _tables_for_keys(unique_keys: np.ndarray, cache: dict) -> np.ndarray:
    """(n_keys, N_SYM+1) cumulative tables for table keys
    ``sigma_idx * MU_GRID + mu_frac`` (lazily built, cached across calls)."""
    missing = [int(k) for k in unique_keys if int(k) not in cache]
    if missing:
        ks = np.asarray(missing, np.int64)
        sig = _SIGMA_VALS[ks // MU_GRID]
        mu = (RC.OFFSET + (ks % MU_GRID) / MU_GRID).astype(np.float32)
        rows = RC.build_cum_tables(sig, mu)
        for k, row in zip(missing, rows):
            cache[k] = row
    return np.stack([cache[int(k)] for k in unique_keys])


def _steps(ch: int, channel_ar: bool):
    """Decode-order step list: one (z, y, w, channel-slice) per coding step.
    Plain ctx decodes a whole position's channels at once (8 steps);
    channel-AR decodes one (position, channel) at a time (8*ch steps)."""
    if channel_ar:
        return [(z, y, w, slice(c, c + 1)) for z, y, w in _RASTER for c in range(ch)]
    return [(z, y, w, slice(None)) for z, y, w in _RASTER]


def encode_latents_ctx(
    lat_int: np.ndarray, ints: Dict[str, np.ndarray], channel_ar: bool = False
) -> dict:
    """Encode integer latents (N,2,2,2,ch) under the context model.

    Proceeds step-by-step (position raster; per channel too in ``channel_ar``
    mode) so that when a residual symbol must be clamped to the alphabet, the
    *decoder-visible* value feeds the later predictions — encoder and decoder
    stay in lockstep by construction. Returns ``{"stream", "shape",
    "n_clamped", "coded"}``; round-trip asserted by the caller via
    :func:`decode_latents_ctx`.
    """
    lat_int = np.asarray(lat_int, np.int64)
    n, ch = lat_int.shape[0], lat_int.shape[-1]
    x = np.zeros_like(lat_int)
    syms, keys = [], []
    n_clamped = 0
    cache: dict = {}
    pred = ExactPredictor(ints)
    for z, y, w, csel in _steps(ch, channel_ar):
        mu16, sidx = pred(x)
        m = mu16[:, z, y, w, csel]
        shift = m >> 4
        frac = m & (MU_GRID - 1)
        sym = lat_int[:, z, y, w, csel] - shift + RC.OFFSET
        clipped = np.clip(sym, 0, RC.N_SYM - 1)
        n_clamped += int((clipped != sym).sum())
        x[:, z, y, w, csel] = clipped - RC.OFFSET + shift
        syms.append(clipped.reshape(-1))
        keys.append((sidx[:, z, y, w, csel] * MU_GRID + frac).reshape(-1))
    flat_syms = np.concatenate(syms).astype(np.int32)
    flat_keys = np.concatenate(keys)
    uk, inv = np.unique(flat_keys, return_inverse=True)
    cum = _tables_for_keys(uk, cache)
    stream = RC.encode(flat_syms, inv.astype(np.int32), cum)
    return {
        "stream": stream,
        "shape": (n, 2, 2, 2, ch),
        "n_clamped": n_clamped,
        # the decoder-visible latents (== lat_int unless clamping occurred);
        # the encoder must reconstruct from THESE for rc_enc == rc_dec
        "coded": x,
    }


def decode_latents_ctx(
    stream: bytes,
    shape: Tuple[int, ...],
    ints: Dict[str, np.ndarray],
    channel_ar: bool = False,
):
    """Inverse of :func:`encode_latents_ctx`: sequential steps (8, or 8*ch in
    channel-AR mode) over ONE resumable native decoder — each step decodes
    only its own symbols under tables predicted from the prefix, so total
    decode work is O(stream), not O(steps x stream)."""
    n, ch = shape[0], shape[-1]
    x = np.zeros(shape, np.int64)
    cache: dict = {}
    pred = ExactPredictor(ints)
    with RC.StreamingDecoder(stream) as dec:
        for z, y, w, csel in _steps(ch, channel_ar):
            mu16, sidx = pred(x)
            m = mu16[:, z, y, w, csel]
            shift = m >> 4
            frac = m & (MU_GRID - 1)
            keys = (sidx[:, z, y, w, csel] * MU_GRID + frac).reshape(-1)
            uk, inv = np.unique(keys, return_inverse=True)
            cum = _tables_for_keys(uk, cache)
            syms = dec.decode(inv.astype(np.int32), cum).astype(np.int64)
            x[:, z, y, w, csel] = syms.reshape(shift.shape) - RC.OFFSET + shift
    return x
