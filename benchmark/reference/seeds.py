"""A frozen copy of the codec's seed stream: the seeded Kaiming inits that
the decoder regenerates and never transmits.

The stream is part of the pack format (the decoder must regenerate the same
init bits years later), so the reference keeps its own copy of the
arithmetic rather than calling the program's: each value is a pure function
of ``(tag, path, counter)`` through BLAKE2b in counter mode, mapped to a
53-bit uniform in float64 and cast once to float32.
"""

from __future__ import annotations

import hashlib

import numpy as np

DEFAULT_TAG = "nvfpcc-tpu/seed-stream/v1"
_CHUNK = 64  # BLAKE2b digest bytes per counter step: 8 uint64 words

# per-layer stream index; part of the format
LAYER_INDEX = {
    "latent_gen": 0, "up0": 1, "conv0": 2, "up1": 3, "conv1": 4, "up2": 5, "conv2": 6,
    "conv2_cls": 7, "conv1_cls": 8, "conv0_cls": 9, "ctx1": 10, "ctx2": 11,
}


def _uint64(tag: str, path: str, n: int) -> np.ndarray:
    prefix = f"{tag}\x1f{path}\x1f".encode("utf-8")
    buf = bytearray()
    for c in range(-(-n * 8 // _CHUNK)):
        buf += hashlib.blake2b(prefix + c.to_bytes(8, "little"), digest_size=_CHUNK).digest()
    return np.frombuffer(bytes(buf[: n * 8]), dtype="<u8")


def _uniform(tag: str, path: str, shape, bound: float) -> np.ndarray:
    n = int(np.prod(shape))
    u01 = (_uint64(tag, path, n) >> np.uint64(11)).astype(np.float64) * (2.0**-53)
    return (-bound + u01 * (2.0 * bound)).astype(np.float32).reshape(shape)


def layer_init(layer: str, kind: str, in_ch: int, out_ch: int, k: int, tag: str = DEFAULT_TAG):
    """(kernel init (k, k, k, in, out) float32, bias init (out,) float32) of
    one seeded layer: Kaiming-uniform with gain sqrt(2) over the fan-in
    (``in * k^3`` for a conv, ``out * k^3`` for a transposed conv), bias
    U(-1/sqrt(in), 1/sqrt(in))."""
    fan_in = (in_ch if kind == "conv" else out_ch) * k**3
    path = f"/{LAYER_INDEX[layer]}"
    kernel = _uniform(tag, path + "/kernel", (k, k, k, in_ch, out_ch),
                      float(np.sqrt(3.0) * np.sqrt(2.0) / np.sqrt(fan_in)))
    bias = _uniform(tag, path + "/bias", (out_ch,), float(1.0 / np.sqrt(in_ch)))
    return kernel, bias
