"""Huffman coding of quantized weight residuals (host, pure numpy).

Capability rebuild of ``util_code_quantized_weights.py``: residual kernels are
scaled by qp (=16) to integers, a Huffman codebook is built from their
empirical histogram, and the symbol stream is bit-packed. The reference uses
the ``bitstream`` pip package and a per-bit string decoder
(``util_code_quantized_weights.py:108-148``); here packing is vectorized
``np.packbits`` and decoding walks a canonical code table in native C
(``native/huffman.cpp``, built on demand like the range coder), with a pure
Python walk as fallback and test oracle. The range-coder path has replaced
Huffman as the default weight codec; this module remains the v2-pack decode
path.

The codebook is serialized in *canonical* form (symbol list + code lengths),
which is both smaller than the reference's pickled dict-of-bitstrings and
deterministic.

Copy of ``nvfpcc_tpu/coder/huffman.py`` (held byte-equal by
``tests/test_torch_shared_copies.py``); the port builds
``native/huffman.cpp`` into its own ``_build/`` (``utils/native.py``).
"""

from __future__ import annotations

import ctypes
import heapq
import subprocess
import threading
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from nvfpcc_tpu_torch.utils import native

_lib = None
_lib_failed = False
_lib_lock = threading.Lock()


def _load_lib():
    """Load (building on first use) the native decoder; None if unavailable
    (no toolchain) — callers fall back to the pure-Python walk."""
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(native.build("huffman.cpp"))
            lib.nvfpcc_huffman_decode.restype = ctypes.c_int
            lib.nvfpcc_huffman_decode.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),  # stream
                ctypes.c_int64,  # stream_bytes
                ctypes.POINTER(ctypes.c_int64),  # symbols
                ctypes.POINTER(ctypes.c_uint8),  # lengths
                ctypes.c_int64,  # n_cb
                ctypes.c_int64,  # n_syms
                ctypes.POINTER(ctypes.c_int64),  # out
            ]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _lib_failed = True
        return _lib


@dataclass
class HuffmanCodebook:
    symbols: np.ndarray  # int64 symbols, sorted by (code length, symbol)
    lengths: np.ndarray  # uint8 code length per symbol

    def to_dict(self) -> dict:
        return {"symbols": self.symbols, "lengths": self.lengths}

    @classmethod
    def from_dict(cls, d: dict) -> "HuffmanCodebook":
        return cls(np.asarray(d["symbols"]), np.asarray(d["lengths"]))


def _code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths via a heap (ties broken deterministically)."""
    n = len(freqs)
    if n == 1:
        return np.array([1], np.uint8)
    heap = [(float(freqs[i]), i, (i,)) for i in range(n)]
    heapq.heapify(heap)
    lengths = np.zeros(n, np.int64)
    counter = n
    while len(heap) > 1:
        fa, _, ia = heapq.heappop(heap)
        fb, _, ib = heapq.heappop(heap)
        for i in ia + ib:
            lengths[i] += 1
        heapq.heappush(heap, (fa + fb, counter, ia + ib))
        counter += 1
    return lengths.astype(np.uint8)


def build_codebook(values: np.ndarray) -> HuffmanCodebook:
    """Codebook from an integer symbol array (reference ``get_pdf`` +
    ``get_huffman_codebook``, ``util_code_quantized_weights.py:53-96``)."""
    symbols, counts = np.unique(np.asarray(values, np.int64), return_counts=True)
    lengths = _code_lengths(counts.astype(np.float64))
    order = np.lexsort((symbols, lengths))
    return HuffmanCodebook(symbols[order], lengths[order])


def _canonical_codes(cb: HuffmanCodebook) -> Tuple[np.ndarray, np.ndarray]:
    """(codes uint64, lengths) in the codebook's canonical order."""
    codes = np.zeros(len(cb.symbols), np.uint64)
    code = 0
    prev_len = int(cb.lengths[0]) if len(cb.lengths) else 0
    for i, ln in enumerate(cb.lengths):
        code <<= int(ln) - prev_len
        codes[i] = code
        code += 1
        prev_len = int(ln)
    return codes, cb.lengths


def encode(values: np.ndarray, cb: HuffmanCodebook) -> bytes:
    """Encode an int array to a byte-padded bitstream."""
    values = np.asarray(values, np.int64).reshape(-1)
    codes, lengths = _canonical_codes(cb)
    sym_to_idx = {int(s): i for i, s in enumerate(cb.symbols)}
    idx = np.fromiter((sym_to_idx[int(v)] for v in values), np.int64, len(values))
    v_codes = codes[idx]
    v_lens = lengths[idx].astype(np.int64)

    total_bits = int(v_lens.sum())
    bits = np.zeros(total_bits, np.uint8)
    pos = np.concatenate([[0], np.cumsum(v_lens)[:-1]])
    maxlen = int(v_lens.max()) if len(v_lens) else 0
    for b in range(maxlen):
        # bit b (MSB-first within each code) of codes long enough
        sel = v_lens > b
        shift = (v_lens[sel] - 1 - b).astype(np.uint64)
        bits[pos[sel] + b] = (v_codes[sel] >> shift) & np.uint64(1)
    return np.packbits(bits).tobytes()


def decode(stream: bytes, cb: HuffmanCodebook, n: int) -> np.ndarray:
    """Decode ``n`` symbols from the bitstream (canonical table walk,
    native C with a pure-Python fallback)."""
    lib = _load_lib()
    if lib is not None:
        buf = np.frombuffer(stream, np.uint8)
        symbols = np.ascontiguousarray(cb.symbols, np.int64)
        lengths = np.ascontiguousarray(cb.lengths, np.uint8)
        out = np.empty(n, np.int64)
        rc = lib.nvfpcc_huffman_decode(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(len(buf)),
            symbols.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_int64(len(symbols)),
            ctypes.c_int64(n),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rc == -2:
            raise ValueError("malformed Huffman codebook")
        if rc != 0:
            raise ValueError("corrupt Huffman stream")
        return out
    return _decode_py(stream, cb, n)


def _decode_py(stream: bytes, cb: HuffmanCodebook, n: int) -> np.ndarray:
    """Pure-Python canonical walk — the native decoder's oracle."""
    bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    codes, lengths = _canonical_codes(cb)
    # first_code[L], first_idx[L] tables for canonical decoding
    max_len = int(lengths.max()) if len(lengths) else 0
    first_code = {}
    first_idx = {}
    for i, ln in enumerate(lengths):
        ln = int(ln)
        if ln not in first_code:
            first_code[ln] = int(codes[i])
            first_idx[ln] = i
    count = {ln: int((lengths == ln).sum()) for ln in first_code}

    out = np.empty(n, np.int64)
    pos = 0
    for t in range(n):
        code = 0
        ln = 0
        while True:
            code = (code << 1) | int(bits[pos])
            pos += 1
            ln += 1
            if ln in first_code:
                offset = code - first_code[ln]
                if 0 <= offset < count[ln]:
                    out[t] = cb.symbols[first_idx[ln] + offset]
                    break
            if ln > max_len:
                raise ValueError("corrupt Huffman stream")
    return out


def expected_length(values: np.ndarray, cb: HuffmanCodebook) -> float:
    """E[code length] in bits/symbol (reference ``est_rate``)."""
    symbols, counts = np.unique(np.asarray(values, np.int64), return_counts=True)
    p = counts / counts.sum()
    lens = {int(s): int(l) for s, l in zip(cb.symbols, cb.lengths)}
    return float(sum(pi * lens[int(s)] for pi, s in zip(p, symbols)))


def encode_tensors(tensors: Sequence[np.ndarray]) -> dict:
    """Pack a list of integer tensors (reference ``enc_dec_from_file`` shape,
    ``util_code_quantized_weights.py:186-209``) with a lossless self-check."""
    flat = np.concatenate([np.asarray(t, np.int64).reshape(-1) for t in tensors])
    cb = build_codebook(flat)
    stream = encode(flat, cb)
    assert np.array_equal(decode(stream, cb, len(flat)), flat), "huffman self-check"
    return {
        "bit_stream": stream,
        "codebook": cb.to_dict(),
        "element_length": int(len(flat)),
        "shape_list": [tuple(np.asarray(t).shape) for t in tensors],
    }


def decode_tensors(pack: dict) -> List[np.ndarray]:
    cb = HuffmanCodebook.from_dict(pack["codebook"])
    flat = decode(pack["bit_stream"], cb, pack["element_length"])
    out = []
    off = 0
    for shape in pack["shape_list"]:
        n = int(np.prod(shape))
        out.append(flat[off : off + n].reshape(shape))
        off += n
    return out
