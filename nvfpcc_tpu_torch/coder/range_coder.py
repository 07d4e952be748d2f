"""Host range coder over integer Gaussian CDF tables (ctypes → native C++).

Copy of ``nvfpcc_tpu/coder/range_coder.py`` (the tables and the streams are
a pack-format contract; ``tests/test_torch_shared_copies.py`` holds the two
byte-equal). The port builds ``native/range_coder.cpp`` into its own
``_build/`` (``utils/native.py``).

Role parity with the reference's arithmetic coder pipeline
(the reference's ``module_arithmeticcoding.cpp`` driven by subprocess at
``NVFPCC.py:459-477,587-607``): entropy-code the rounded latent symbols under
per-channel Gaussian models, with bit-exact encode/decode reciprocity.

Determinism design (stronger than the reference's): the reference evaluates
float ``erf()`` CDFs inside the coder on both ends and masks float mantissas so
the two evaluations agree (``set_FL_MASK``, ``module_arithmeticcoding.cpp:93-113``).
Here all float math happens exactly once, in :func:`build_cum_tables` on the
host, from the float32 sigma/mu that ship in the pack; the native coder
consumes only integer cumulative-frequency tables, so encoder and decoder
agree by construction — no mantissa masking needed, and no float ops anywhere
near the bitstream.

Symbols are latent integers offset by ``OFFSET`` into ``[0, N_SYM)`` (the
reference uses the same +512 offset and a 1025-symbol alphabet,
``NVFPCC.py:447-468``). One table per latent channel; the per-symbol table id
stream is just ``channel_of(symbol_position)``.
"""

from __future__ import annotations

import ctypes
import math
import threading

import numpy as np

from nvfpcc_tpu_torch.utils import native

N_SYM = 1025  # alphabet size (latents +512, matching the reference's range)
OFFSET = 512
TOTAL = 1 << 20  # shared cumulative-frequency total for every table

FACTORIZED_FILTERS = (1, 3, 3, 3, 1)  # reference CDFModel.filters (nvfpcc_tpu/ops/rate.py)

_lib = None
_lib_lock = threading.Lock()


def _load_lib() -> ctypes.CDLL:
    """Load (building on first use) the native coder shared library."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(native.build("range_coder.cpp"))
        lib.nvfpcc_rc_encode.restype = ctypes.c_long
        lib.nvfpcc_rc_encode.argtypes = [
            ctypes.POINTER(ctypes.c_int32),  # symbols
            ctypes.POINTER(ctypes.c_int32),  # table_ids
            ctypes.c_long,  # n
            ctypes.POINTER(ctypes.c_uint32),  # cum
            ctypes.c_int,  # ntab
            ctypes.c_int,  # tabsize
            ctypes.POINTER(ctypes.c_uint8),  # out
            ctypes.c_long,  # out_capacity
        ]
        lib.nvfpcc_rc_decode.restype = ctypes.c_long
        lib.nvfpcc_rc_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # in
            ctypes.c_long,  # in_len
            ctypes.POINTER(ctypes.c_int32),  # table_ids
            ctypes.c_long,  # n
            ctypes.POINTER(ctypes.c_uint32),  # cum
            ctypes.c_int,  # ntab
            ctypes.c_int,  # tabsize
            ctypes.POINTER(ctypes.c_int32),  # out_symbols
        ]
        lib.nvfpcc_rc_dec_new.restype = ctypes.c_void_p
        lib.nvfpcc_rc_dec_new.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_long,
        ]
        lib.nvfpcc_rc_dec_run.restype = ctypes.c_long
        lib.nvfpcc_rc_dec_run.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.nvfpcc_rc_dec_free.restype = None
        lib.nvfpcc_rc_dec_free.argtypes = [ctypes.c_void_p]
        lib.nvfpcc_erf_batch.restype = None
        lib.nvfpcc_erf_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long,
        ]
        _lib = lib
        return _lib


# Batch erf: the Python math.erf loop costs ~1 us/element, which dominates
# table building when an autoregressive decode touches thousands of distinct
# (sigma, mu) tables. The native libm batch is ~50x faster — but erf values
# feed the integer tables both coder ends must rebuild identically, so the
# native path is trusted only after a bit-exactness probe against math.erf
# (falls back to the Python loop on any mismatch, keeping old packs safe).
_erf_impl = None


def _erf_batch(x: np.ndarray) -> np.ndarray:
    global _erf_impl
    if _erf_impl is None:
        _erf_impl = _select_erf_impl()
    return _erf_impl(x)


def _erf_py(x: np.ndarray) -> np.ndarray:
    return np.asarray([math.erf(v) for v in x.ravel()], np.float64).reshape(x.shape)


def _select_erf_impl():
    try:
        lib = _load_lib()
    except Exception:
        return _erf_py

    def native(x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, np.float64)
        out = np.empty(x.size, np.float64)
        lib.nvfpcc_erf_batch(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            x.size,
        )
        return out.reshape(x.shape)

    # bit-exactness probe over the value range tables actually use
    probe = np.concatenate(
        [
            np.linspace(-40.0, 40.0, 4001),
            np.asarray([0.0, -0.0, 1e-12, -1e-12, 745.0, -745.0]),
        ]
    )
    if np.array_equal(native(probe), _erf_py(probe)):
        return native
    return _erf_py


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return 0.5 * (1.0 + _erf_batch(z / math.sqrt(2.0)))


def build_cum_tables(
    sigma: np.ndarray,
    mu: np.ndarray,
    n_sym: int = N_SYM,
    offset: int = OFFSET,
    total: int = TOTAL,
) -> np.ndarray:
    """Integer cumulative-frequency tables from per-table Gaussian (sigma, mu).

    ``sigma``/``mu`` are float32 arrays of shape (ntab,) in *symbol* space
    (i.e. already offset; callers pass ``mu + offset``). Returns uint32
    ``(ntab, n_sym + 1)`` with ``cum[:, 0] == 0`` and ``cum[:, -1] == total``.
    Every symbol gets frequency >= 1 so any symbol stays decodable (the
    reference guarantees the same with its frequency floor,
    ``module_arithmeticcoding.cpp:150-170``).

    All math is float64 from float32 inputs — deterministic across hosts; the
    coder itself never sees a float.
    """
    sigma = np.asarray(sigma, np.float32).astype(np.float64).reshape(-1)
    mu = np.asarray(mu, np.float32).astype(np.float64).reshape(-1)
    ntab = len(sigma)
    sigma = np.maximum(sigma, 1e-9)

    edges = np.arange(n_sym + 1, dtype=np.float64) - 0.5  # bin edges in symbol space
    z = (edges[None, :] - mu[:, None]) / sigma[:, None]
    cdf = _norm_cdf(z)
    pdf = np.diff(cdf, axis=1)
    pdf = pdf / np.maximum(pdf.sum(axis=1, keepdims=True), 1e-300)

    return _integerize_pdfs(pdf, total)


def _integerize_pdfs(pdf: np.ndarray, total: int) -> np.ndarray:
    """(ntab, n_sym) probability rows -> uint32 cumulative tables summing to
    ``total`` with every frequency >= 1 (deterministic remainder assignment).

    Fully vectorized over tables (the per-table Python loop dominated
    autoregressive decodes that build thousands of tables); the assignment
    rule — and therefore every table bit — is unchanged: floor + 1, spread
    the remainder evenly, top up the largest fractional bins with ties broken
    by symbol index ascending.
    """
    ntab, n_sym = pdf.shape
    budget = total - n_sym
    scaled = pdf * budget
    fl = np.floor(scaled)
    freqs = fl.astype(np.int64) + 1
    short = total - freqs.sum(axis=1)
    assert np.all(short >= 0)
    # k can exceed n_sym when the mass falls outside the window (degenerate
    # models): spread evenly, then top up the largest fractional bins.
    base, rem = np.divmod(short, n_sym)
    freqs += base[:, None]
    frac = scaled - fl
    # stable argsort on -frac == lexsort((arange, -frac)): ties by index asc
    order = np.argsort(-frac, axis=1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(
        ranks, order, np.broadcast_to(np.arange(n_sym), (ntab, n_sym)), axis=1
    )
    freqs += ranks < rem[:, None]
    cum = np.zeros((ntab, n_sym + 1), np.uint32)
    cum[:, 1:] = np.cumsum(freqs, axis=1).astype(np.uint32)
    assert np.all(cum[:, -1] == total)
    return cum


def build_cum_tables_gmm(
    sigma: np.ndarray,
    mu: np.ndarray,
    p_logit: np.ndarray,
    n_sym: int = N_SYM,
    offset: int = OFFSET,
    total: int = TOTAL,
) -> np.ndarray:
    """Integer tables for per-channel 2-component Gaussian mixtures.

    ``sigma``/``mu`` are (2, ntab) f32 in LATENT space (mu is shifted by
    ``offset`` internally), ``p_logit`` (ntab,). Same determinism contract as
    :func:`build_cum_tables` (float64 from f32, erf on host)."""
    sigma = np.abs(np.asarray(sigma, np.float32).astype(np.float64)).reshape(2, -1)
    mu = np.asarray(mu, np.float32).astype(np.float64).reshape(2, -1)
    p = _sigmoid64(np.asarray(p_logit, np.float32).astype(np.float64).reshape(-1))
    sigma = np.maximum(sigma, 1e-9)
    edges = np.arange(n_sym + 1, dtype=np.float64) - 0.5 - offset
    cdf = np.zeros((mu.shape[1], n_sym + 1), np.float64)
    for comp, w in ((0, p), (1, 1.0 - p)):
        z = (edges[None, :] - mu[comp][:, None]) / sigma[comp][:, None]
        cdf += w[:, None] * _norm_cdf(z)
    pdf = np.diff(cdf, axis=1)
    pdf = np.maximum(pdf, 0.0)
    pdf = pdf / np.maximum(pdf.sum(axis=1, keepdims=True), 1e-300)
    return _integerize_pdfs(pdf, total)


def _sigmoid64(x: np.ndarray) -> np.ndarray:
    # stable, deterministic logistic (tanh-based; no exp overflow)
    return 0.5 * (1.0 + np.tanh(0.5 * x))


def build_cum_tables_factorized(
    params: dict,
    ch: int,
    n_sym: int = N_SYM,
    offset: int = OFFSET,
    total: int = TOTAL,
) -> np.ndarray:
    """Integer tables for the per-channel factorized (monotone logit-CDF MLP)
    model. ``params`` holds f32 arrays ``matrix_i`` (ch, fin, fout),
    ``bias_i`` (ch, fout), ``factor_i`` (ch, fout) — the same leaves the jax
    model trains (``ops/rate.py:factorized_logit_cdf``), evaluated here in
    float64 numpy (einsum — no BLAS) so both ends build identical tables from
    the f32 values in the pack."""
    F = FACTORIZED_FILTERS
    edges = np.arange(n_sym + 1, dtype=np.float64) - 0.5 - offset
    y = np.broadcast_to(edges[None, :, None], (ch, n_sym + 1, 1)).copy()
    for i in range(len(F) - 1):
        m = np.asarray(params[f"matrix_{i}"], np.float32).astype(np.float64)
        b = np.asarray(params[f"bias_{i}"], np.float32).astype(np.float64)
        m = np.logaddexp(0.0, m)  # softplus
        y = np.einsum("cei,cio->ceo", y, m, optimize=False) + b[:, None, :]
        if i < len(F) - 2:
            a = np.asarray(params[f"factor_{i}"], np.float32).astype(np.float64)
            y = y + np.tanh(a)[:, None, :] * np.tanh(y)
    cdf = _sigmoid64(y[..., 0])
    pdf = np.diff(cdf, axis=1)
    pdf = np.maximum(pdf, 0.0)
    pdf = pdf / np.maximum(pdf.sum(axis=1, keepdims=True), 1e-300)
    return _integerize_pdfs(pdf, total)


def encode_latents_tables(latents: np.ndarray, cum: np.ndarray) -> dict:
    """Encode integer latents (N,2,2,2,ch) under prebuilt per-CHANNEL tables
    (one table per channel; used by the gmm/factorized modes). Returns
    ``{"stream", "shape"}``; round-trip asserted."""
    latents = np.asarray(latents)
    ints = np.rint(latents).astype(np.int64)
    symbols = ints + OFFSET
    if symbols.min() < 0 or symbols.max() >= N_SYM:
        raise ValueError("latent out of codable range")
    ch = latents.shape[-1]
    ids = np.broadcast_to(np.arange(ch, dtype=np.int32), latents.shape).reshape(-1)
    stream = encode(symbols.reshape(-1), ids, cum)
    rt = decode(stream, ids, cum)
    assert np.array_equal(rt, symbols.reshape(-1)), "range coder round-trip failed"
    return {"stream": stream, "shape": tuple(latents.shape)}


def decode_latents_tables(stream: bytes, shape, cum: np.ndarray) -> np.ndarray:
    """Inverse of :func:`encode_latents_tables`. Returns float32 latents."""
    ch = shape[-1]
    ids = np.broadcast_to(np.arange(ch, dtype=np.int32), shape).reshape(-1)
    symbols = decode(stream, ids, cum)
    return (symbols.astype(np.int64) - OFFSET).astype(np.float32).reshape(shape)


def build_cum_from_counts(counts: np.ndarray, total: int = TOTAL) -> np.ndarray:
    """(ntab, n+1) cumulative tables from empirical symbol histograms
    (used for the weight-residual stream — ~3% tighter than Huffman).
    Accepts one 1-D histogram or a 2-D (ntab, n) stack of equal-width rows
    (shorter alphabets zero-padded; padding symbols get the frequency floor
    and are never emitted)."""
    counts = np.asarray(counts, np.float64)
    if counts.ndim == 1:
        counts = counts.reshape(1, -1)
    s = counts.sum(axis=1, keepdims=True)
    if np.any(s <= 0):
        raise ValueError("histogram is empty")
    return _integerize_pdfs(counts / s, total)


def encode(symbols: np.ndarray, table_ids: np.ndarray, cum: np.ndarray) -> bytes:
    """Range-encode ``symbols`` (int, in [0, n_sym)) under per-symbol tables."""
    lib = _load_lib()
    symbols = np.ascontiguousarray(symbols, np.int32).reshape(-1)
    table_ids = np.ascontiguousarray(table_ids, np.int32).reshape(-1)
    if symbols.shape != table_ids.shape:
        raise ValueError("symbols and table_ids must have the same length")
    cum = np.ascontiguousarray(cum, np.uint32)
    ntab, tabsize = cum.shape
    # worst case: every symbol at the frequency floor -> log2(total) bits/sym
    cap = 16 + len(symbols) * (int(math.ceil(math.log2(cum[0, -1]))) // 8 + 2)
    out = np.empty(cap, np.uint8)
    n = lib.nvfpcc_rc_encode(
        symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        table_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(symbols),
        cum.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ntab,
        tabsize,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cap,
    )
    if n < 0:
        raise ValueError("range encode failed (bad symbol/table input)")
    return out[:n].tobytes()


def decode(stream: bytes, table_ids: np.ndarray, cum: np.ndarray) -> np.ndarray:
    """Decode ``len(table_ids)`` symbols from the stream. Returns int32."""
    lib = _load_lib()
    table_ids = np.ascontiguousarray(table_ids, np.int32).reshape(-1)
    cum = np.ascontiguousarray(cum, np.uint32)
    ntab, tabsize = cum.shape
    buf = np.frombuffer(stream, np.uint8)
    buf = np.ascontiguousarray(buf)
    out = np.empty(len(table_ids), np.int32)
    n = lib.nvfpcc_rc_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(buf),
        table_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(table_ids),
        cum.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ntab,
        tabsize,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n != len(table_ids):
        raise ValueError("range decode failed")
    return out


class StreamingDecoder:
    """Resumable decoder over one stream: each :meth:`decode` call consumes
    the next ``len(table_ids)`` symbols, persisting coder state in the native
    handle between calls. This is what makes autoregressive host coding
    (``coder/ctx_coder.py``) O(stream) instead of O(steps x stream): each of
    the 8 (or 8*ch) sequential steps decodes only its own symbols, with
    tables that may depend on everything decoded so far.

    Use as a context manager (or call :meth:`close`); the handle owns a copy
    of the stream buffer on the native side.
    """

    def __init__(self, stream: bytes):
        self._lib = _load_lib()
        buf = np.frombuffer(stream, np.uint8)
        buf = np.ascontiguousarray(buf)
        self._handle = self._lib.nvfpcc_rc_dec_new(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf)
        )
        if not self._handle:
            raise ValueError("failed to initialize streaming decoder")

    def decode(self, table_ids: np.ndarray, cum: np.ndarray) -> np.ndarray:
        """Decode the next ``len(table_ids)`` symbols under per-call tables
        (``cum`` rows must share the global TOTAL). Returns int32."""
        if self._handle is None:
            raise ValueError("decoder already closed")
        table_ids = np.ascontiguousarray(table_ids, np.int32).reshape(-1)
        cum = np.ascontiguousarray(cum, np.uint32)
        ntab, tabsize = cum.shape
        out = np.empty(len(table_ids), np.int32)
        n = self._lib.nvfpcc_rc_dec_run(
            self._handle,
            table_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(table_ids),
            cum.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ntab,
            tabsize,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if n != len(table_ids):
            raise ValueError("streaming range decode failed")
        return out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.nvfpcc_rc_dec_free(self._handle)
            self._handle = None

    def __enter__(self) -> "StreamingDecoder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# latent-level convenience API (what the codec layer uses)
# ---------------------------------------------------------------------------


def _latent_tables(shape, sigma: np.ndarray, mu: np.ndarray):
    """(sigma32, mu32, table_ids) for per-block latents of ``shape``.

    The model params may be per-channel ``(ch,)`` (the reference's active
    ``QuantGaussianLikelihood``) or per-position ``shape[1:]`` (the
    dormant ``SpatioQuantGaussianLikelihood`` design,
    ``utils/network.py:4554-4590``) — one integer table per parameter either
    way; per-symbol table id is just its (position-)index within the block.
    """
    ch = shape[-1]
    per_block = tuple(shape[1:])
    sigma = np.asarray(sigma, np.float32)
    mu = np.asarray(mu, np.float32)
    if sigma.size == ch:
        sigma32, mu32 = sigma.reshape(ch), mu.reshape(ch)
        ids = np.broadcast_to(np.arange(ch, dtype=np.int32), shape).reshape(-1)
    elif sigma.size == int(np.prod(per_block)):
        sigma32, mu32 = sigma.reshape(-1), mu.reshape(-1)
        ids = np.broadcast_to(
            np.arange(sigma.size, dtype=np.int32).reshape(per_block), shape
        ).reshape(-1)
    else:
        raise ValueError(
            f"entropy params of size {sigma.size} fit neither per-channel ({ch}) "
            f"nor per-position ({int(np.prod(per_block))})"
        )
    return sigma32, mu32, ids


def encode_latents(latents: np.ndarray, sigma: np.ndarray, mu: np.ndarray) -> dict:
    """Encode integer latents (N, 2, 2, 2, ch) under Gaussian models.

    Mirrors the reference's latent serialization (``NVFPCC.py:444-477``);
    symbols are latent + OFFSET. Returns the latent pack dict (stream + the
    exact f32 model params needed to decode)."""
    latents = np.asarray(latents)
    ints = np.rint(latents).astype(np.int64)
    symbols = ints + OFFSET
    if symbols.min() < 0 or symbols.max() >= N_SYM:
        raise ValueError(
            f"latent out of codable range [-{OFFSET}, {N_SYM - OFFSET}): "
            f"[{ints.min()}, {ints.max()}]"
        )
    sigma32, mu32, table_ids = _latent_tables(latents.shape, sigma, mu)
    cum = build_cum_tables(sigma32, mu32 + OFFSET)
    stream = encode(symbols.reshape(-1), table_ids, cum)
    # reciprocity self-check, as the reference asserts at encode (NVFPCC.py:466-470)
    rt = decode(stream, table_ids, cum)
    assert np.array_equal(rt, symbols.reshape(-1)), "range coder round-trip failed"
    return {
        "stream": stream,
        "sigma": np.asarray(sigma, np.float32),
        "mu": np.asarray(mu, np.float32),
        "shape": tuple(latents.shape),
    }


def decode_latents(pack: dict) -> np.ndarray:
    """Inverse of :func:`encode_latents`. Returns float32 latents."""
    shape = tuple(pack["shape"])
    sigma32, mu32, table_ids = _latent_tables(shape, pack["sigma"], pack["mu"])
    cum = build_cum_tables(sigma32, mu32 + OFFSET)
    symbols = decode(pack["stream"], table_ids, cum)
    return (symbols.astype(np.int64) - OFFSET).astype(np.float32).reshape(shape)


def _selftest() -> None:
    rng = np.random.default_rng(0)
    for trial in range(5):
        ch = int(rng.integers(1, 6))
        n = int(rng.integers(1, 64))
        sigma = rng.uniform(0.05, 30.0, ch).astype(np.float32)
        mu = rng.uniform(-5, 5, ch).astype(np.float32)
        lat = np.clip(
            rng.normal(mu, sigma * 3, (n, 2, 2, 2, ch)), -OFFSET, N_SYM - OFFSET - 1
        )
        lat = np.rint(lat).astype(np.float32)
        pack = encode_latents(lat, sigma, mu)
        out = decode_latents(pack)
        assert np.array_equal(out, lat), f"trial {trial} mismatch"
        bits = 8 * len(pack["stream"])
        print(f"trial {trial}: {lat.size} syms -> {bits} bits ({bits / lat.size:.2f} b/sym)")
    print("range coder selftest OK")


if __name__ == "__main__":
    import sys

    if "--selftest" in sys.argv:
        _selftest()
