"""Decoder-weight quantization and entropy packing (port of
``nvfpcc_tpu/codec/weights.py``).

Host numpy over params trees in the JAX layout, so packs are byte-compatible
with the JAX package's. The coders are the port's copies
(``nvfpcc_tpu_torch.coder``). Modes: ``auto`` (the smaller of ``range_pl`` and
``range``, format v4), ``range_pl``, ``range``, ``huffman`` (v1/v2 packs),
and ``gaussian``, which codes under the trained scalar-Gaussian weight-rate
model (the prior the RD objective optimizes): its table side-info is two
f32 instead of a histogram, at the cost of model-vs-empirical mismatch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nvfpcc_tpu_torch.coder import huffman
from nvfpcc_tpu_torch.coder import range_coder as RC
from nvfpcc_tpu_torch.models.decoder import CTX_KERNELS, TRANSMITTED_KERNELS

# as-is (fp32, uncoded) leaves of the decode tree: path -> copied verbatim
_AS_IS_KEYS = tuple(f"{n}/b" for n in TRANSMITTED_KERNELS) + ("igdn/beta", "igdn/gamma")


def _round_kernel(layer: dict, qp: int) -> dict:
    k = np.asarray(layer["kernel"], np.float64)
    return {**layer, "kernel": (np.rint(k * qp) / qp).astype(np.float32)}


def quantize_residuals(params: dict, qp: int = 16) -> dict:
    """``params`` with every transmitted kernel residual rounded to the 1/qp
    grid (float64 round -> float32 values, as the JAX package does): the 7
    decoder kernels, plus the 2 ctx-model masked kernels when present."""
    out = {**params, "decoder": {
        **params["decoder"], **{n: _round_kernel(params["decoder"][n], qp) for n in TRANSMITTED_KERNELS}
    }}
    ep = params.get("entropy", {})
    if all(n in ep for n in CTX_KERNELS):
        out["entropy"] = {**ep, **{n: _round_kernel(ep[n], qp) for n in CTX_KERNELS}}
    return out


def _kernel_ints(dp: dict, qp: int):
    ints = []
    for name in TRANSMITTED_KERNELS:
        k = np.asarray(dp[name]["kernel"], np.float64) * qp
        ik = np.rint(k).astype(np.int64)
        if not np.allclose(k, ik, atol=1e-4):
            raise ValueError(
                f"kernel residual '{name}' is not on the 1/{qp} grid — "
                "run quantize_residuals first"
            )
        ints.append(ik)
    return ints


def pack_weights(params: dict, qp: int = 16, entropy: str = "auto") -> dict:
    """Entropy-pack the decode-relevant weights of a quantized params tree
    into the ``net_weight_pack`` dict."""
    if entropy == "auto":
        a = pack_weights(params, qp, entropy="range_pl")
        b = pack_weights(params, qp, entropy="range")
        return a if weight_pack_bits(a)[0] <= weight_pack_bits(b)[0] else b
    dp = params["decoder"]
    ints = _kernel_ints(dp, qp)
    pack = {
        "qp": int(qp),
        "kernel_keys": list(TRANSMITTED_KERNELS),
        "shape_list": [tuple(t.shape) for t in ints],
        "element_length": int(sum(t.size for t in ints)),
    }
    if entropy == "range_pl":
        pack.update({"mode": "range_pl", **pack_int_stream_layered(ints)})
    elif entropy == "range":
        pack.update({"mode": "range", **pack_int_stream(np.concatenate([t.reshape(-1) for t in ints]))})
    elif entropy == "gaussian":
        wr = dp.get("wrate")
        if wr is None:
            raise ValueError("entropy='gaussian' needs the trained wrate params")
        flat = np.concatenate([t.reshape(-1) for t in ints])
        sigma = np.float32(abs(np.asarray(wr["sigma"]).reshape(-1)[0]))
        mu = np.float32(np.asarray(wr["mu"]).reshape(-1)[0])
        lo, hi = int(flat.min()), int(flat.max())
        cum = _gaussian_weight_tables(sigma, mu, lo, hi, qp)
        symbols = (flat - lo).astype(np.int32)
        table_ids = np.zeros(len(symbols), np.int32)
        stream = RC.encode(symbols, table_ids, cum)
        if not np.array_equal(RC.decode(stream, table_ids, cum), symbols):
            raise RuntimeError("gaussian weight-coding self-check failed")
        pack.update({
            "mode": "gaussian", "bit_stream": stream, "min_sym": lo, "max_sym": hi,
            "wrate_sigma": sigma, "wrate_mu": mu,
        })
    elif entropy == "huffman":
        hpack = huffman.encode_tensors(ints)
        pack.update({"mode": "huffman", "bit_stream": hpack["bit_stream"], "codebook": hpack["codebook"]})
    else:
        raise ValueError(f"unsupported weight entropy codec: {entropy}")
    as_is_pool = {}
    for key in _AS_IS_KEYS:
        node = dp
        for part in key.split("/"):
            node = node[part]
        as_is_pool[key] = np.asarray(node, np.float32)
    pack["as_is_pool"] = as_is_pool
    return pack


def _cum_matrix(counts_list) -> np.ndarray:
    width = max(len(c) for c in counts_list)
    cmat = np.zeros((len(counts_list), width), np.int64)
    for i, c in enumerate(counts_list):
        cmat[i, : len(c)] = c
    return RC.build_cum_from_counts(cmat)


def pack_int_stream(flat: np.ndarray) -> dict:
    """Range-code a flat int array under its empirical histogram
    (round-trip checked)."""
    flat = np.asarray(flat, np.int64).reshape(-1)
    lo, hi = int(flat.min()), int(flat.max())
    counts = np.bincount(flat - lo, minlength=hi - lo + 1)
    cum = RC.build_cum_from_counts(counts)
    symbols = (flat - lo).astype(np.int32)
    table_ids = np.zeros(len(symbols), np.int32)
    stream = RC.encode(symbols, table_ids, cum)
    if not np.array_equal(RC.decode(stream, table_ids, cum), symbols):
        raise RuntimeError("int-stream range-coding self-check failed")
    return {"bit_stream": stream, "min_sym": lo, "counts": counts.astype(np.int64)}


def unpack_int_stream(pack: dict, n: int) -> np.ndarray:
    cum = RC.build_cum_from_counts(pack["counts"])
    flat = RC.decode(pack["bit_stream"], np.zeros(n, np.int32), cum).astype(np.int64)
    return flat + int(pack["min_sym"])


def int_stream_bits(pack: dict) -> int:
    """Stream + histogram-table bits of a :func:`pack_int_stream` payload."""
    return 8 * len(pack["bit_stream"]) + 16 + len(np.asarray(pack["counts"])) * 24


def pack_int_stream_layered(tensors) -> dict:
    """Range-code int tensors as ONE stream under per-tensor empirical
    histograms (round-trip checked)."""
    flats = [np.asarray(t, np.int64).reshape(-1) for t in tensors]
    mins = np.array([int(f.min()) for f in flats], np.int64)
    counts_list = [np.bincount(f - mn).astype(np.int64) for f, mn in zip(flats, mins)]
    cum = _cum_matrix(counts_list)
    symbols = np.concatenate([(f - mn).astype(np.int32) for f, mn in zip(flats, mins)])
    table_ids = np.concatenate([np.full(len(f), i, np.int32) for i, f in enumerate(flats)])
    stream = RC.encode(symbols, table_ids, cum)
    if not np.array_equal(RC.decode(stream, table_ids, cum), symbols):
        raise RuntimeError("layered int-stream range-coding self-check failed")
    return {"bit_stream": stream, "min_syms": mins, "counts_list": counts_list}


def unpack_int_stream_layered(pack: dict, sizes) -> np.ndarray:
    counts_list = [np.asarray(c, np.int64) for c in pack["counts_list"]]
    cum = _cum_matrix(counts_list)
    table_ids = np.concatenate([np.full(int(n), i, np.int32) for i, n in enumerate(sizes)])
    flat = RC.decode(pack["bit_stream"], table_ids, cum).astype(np.int64)
    return flat + np.repeat(np.asarray(pack["min_syms"], np.int64), np.asarray(sizes, np.int64))


def _gaussian_weight_tables(sigma, mu, lo: int, hi: int, qp: int) -> np.ndarray:
    """One integer table over residual ints [lo, hi] from the trained scalar
    Gaussian at step 1/qp: symbol i <-> residual value (lo+i)/qp, so in
    symbol space sigma' = sigma*qp, mu' = mu*qp - lo."""
    return RC.build_cum_tables(
        np.asarray([np.float64(sigma) * qp], np.float32),
        np.asarray([np.float64(mu) * qp - lo], np.float32),
        n_sym=hi - lo + 1,
    )


def _decode_weight_ints(pack: dict):
    """Per-kernel int tensors (packs without a mode field are v1/v2 Huffman)."""
    n = int(pack["element_length"])
    mode = pack.get("mode", "huffman")
    if mode == "range_pl":
        flat = unpack_int_stream_layered(pack, [int(np.prod(s)) for s in pack["shape_list"]])
    elif mode == "range":
        flat = unpack_int_stream(pack, n)
    elif mode == "huffman":
        flat = huffman.decode(pack["bit_stream"], huffman.HuffmanCodebook.from_dict(pack["codebook"]), n)
    elif mode == "gaussian":
        lo, hi = int(pack["min_sym"]), int(pack["max_sym"])
        cum = _gaussian_weight_tables(pack["wrate_sigma"], pack["wrate_mu"], lo, hi, int(pack["qp"]))
        flat = RC.decode(pack["bit_stream"], np.zeros(n, np.int32), cum).astype(np.int64) + lo
    else:
        raise ValueError(
            f"unsupported weight entropy mode {mode!r} — pack written by a newer format version?"
        )
    out, off = [], 0
    for shape in pack["shape_list"]:
        size = int(np.prod(shape))
        out.append(flat[off : off + size].reshape(shape))
        off += size
    return out


def unpack_weights(pack: dict) -> dict:
    """The decode-minimal ``{"decoder": ...}`` numpy tree from a pack."""
    qp = int(pack["qp"])
    dp: dict = {}
    for name, ik in zip(pack["kernel_keys"], _decode_weight_ints(pack)):
        dp[name] = {"kernel": (ik.astype(np.float64) / qp).astype(np.float32)}
    for key, value in pack["as_is_pool"].items():
        parts = key.split("/")
        node = dp
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(value, np.float32)
    return {"decoder": dp}


def weight_pack_bits(pack: dict) -> Tuple[int, int]:
    """(coded_bits, as_is_bits): entropy stream + table overhead vs the fp32
    pool."""
    mode = pack.get("mode", "huffman")
    if mode == "range_pl":
        table_bits = sum(16 + len(np.asarray(c)) * 24 for c in pack["counts_list"])
    elif mode == "range":
        table_bits = 16 + len(np.asarray(pack["counts"])) * 24
    elif mode == "gaussian":
        table_bits = 2 * 32 + 2 * 16  # (sigma, mu) f32 + (min, max) int16
    else:
        table_bits = len(np.asarray(pack["codebook"]["symbols"])) * (16 + 8)
    coded = 8 * len(pack["bit_stream"]) + table_bits
    as_is = 32 * sum(int(np.asarray(v).size) for v in pack["as_is_pool"].values())
    return coded, as_is


def check_quantized(params: dict, qp: int = 16) -> bool:
    """True iff all transmitted kernel residuals are on the 1/qp grid
    (the reference's discreteness precondition,
    ``util_code_quantized_weights.py:46-50``). ``params`` is a numpy tree
    (``utils.params.params_to_numpy``)."""
    dp = params["decoder"]
    for name in TRANSMITTED_KERNELS:
        k = np.asarray(dp[name]["kernel"], np.float64) * qp
        if not np.allclose(k, np.rint(k), atol=1e-4):
            return False
    return True
