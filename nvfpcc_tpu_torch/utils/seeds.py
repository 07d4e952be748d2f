"""Deterministic named seed streams for decoder-regenerable inits.

The reference ships out-of-band seed files (``SEED3.npy``/``SEED4_Gaussian.npy``,
``utils/network.py:20-22``) so that encoder and decoder regenerate identical
Kaiming init tensors without transmitting them. We replace the side files with
a **self-contained counter-mode hash generator**: init values are a pure
function of ``(seed tag, layer path, counter)`` via BLAKE2b, so

- encoder and decoder regenerate bit-identical inits with no side files,
- the stream is part of the *bitstream format contract* — it depends on no
  RNG library's version-specific algorithm (numpy streams and jax threefry
  may both evolve; a pack encoded today must decode years from now),
- generation is pure host numpy, costing microseconds (an eager
  ``jax.random`` op here would pay an XLA compile per layer per process).

Copy of ``nvfpcc_tpu/utils/seeds.py``: the stream is a format contract (the
decoder regenerates the init bits), held equal to the original by
``tests/test_torch_shared_copies.py``.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

DEFAULT_TAG = "nvfpcc-tpu/seed-stream/v1"

_CHUNK = 64  # blake2b digest bytes -> 8 uint64 words per counter step


class SeedKey(NamedTuple):
    """Names one position in the seed stream: a tag plus a '/'-joined path."""

    tag: str
    path: str = ""


def base_key(tag: str = DEFAULT_TAG) -> SeedKey:
    return SeedKey(tag=tag)


def layer_key(key: SeedKey, index) -> SeedKey:
    """Per-layer subkey (the reference's role for its SEED2 stream pointer,
    ``utils/network.py:20-22,711-715``)."""
    return SeedKey(key.tag, f"{key.path}/{index}")


def sub_key(key: SeedKey, label: str) -> SeedKey:
    return SeedKey(key.tag, f"{key.path}/{label}")


def _raw_uint64(key: SeedKey, n: int) -> np.ndarray:
    """n uint64 words from BLAKE2b in counter mode over (tag|path|counter)."""
    prefix = f"{key.tag}\x1f{key.path}\x1f".encode("utf-8")
    n_chunks = -(-n * 8 // _CHUNK)
    buf = bytearray()
    for c in range(n_chunks):
        buf += hashlib.blake2b(prefix + c.to_bytes(8, "little"), digest_size=_CHUNK).digest()
    return np.frombuffer(bytes(buf[: n * 8]), dtype="<u8")


def uniform(key: SeedKey, shape, lo: float, hi: float) -> np.ndarray:
    """float32 U[lo, hi) tensor from the named stream (C-order fill)."""
    n = int(np.prod(shape)) if len(shape) else 1
    bits = _raw_uint64(key, n)
    # 53-bit mantissa path: exact in f64, then cast once to f32
    u01 = (bits >> np.uint64(11)).astype(np.float64) * (2.0**-53)
    return (lo + u01 * (hi - lo)).astype(np.float32).reshape(shape)


def kaiming_uniform(key: SeedKey, shape, fan_in: int, gain: float = float(np.sqrt(2.0))):
    """Kaiming-uniform init: U(-b, b) with b = sqrt(3)*gain/sqrt(fan_in).

    Same scheme the reference derives from its seed files
    (``get_kaiming_init_from_seed``, ``utils/network.py:392-400``).
    """
    bound = float(np.sqrt(3.0) * gain / np.sqrt(fan_in))
    return uniform(key, shape, -bound, bound)


def uniform_bias(key: SeedKey, shape, fan_in: int):
    """Bias init U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (reference ``utils/network.py:594-599``)."""
    bound = float(1.0 / np.sqrt(fan_in))
    return uniform(key, shape, -bound, bound)
