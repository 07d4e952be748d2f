"""Median milliseconds of a decode's ``codec.reconstruct_points`` (the
f32 reconstruction, threshold and point extraction), a host span that ends
after the device's work."""

import statistics


def read(obs):
    ms = obs.get("recon_ms")
    return statistics.median(ms) if ms else None
