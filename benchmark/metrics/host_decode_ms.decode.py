"""Median milliseconds a decode spends in the host coders:
``codec.load_pack``, ``weights.unpack_weights``, ``codec.decode_latent_pack``
and ``codec.decode_origins``, summed per decode."""

import statistics


def read(obs):
    ms = obs.get("host_decode_ms")
    return statistics.median(ms) if ms else None
