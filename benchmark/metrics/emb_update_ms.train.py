"""Median milliseconds of an epoch's full-set embedding update
(``EpochProgram.emb_update``), CUDA events around the call."""

import statistics


def read(obs):
    ms = obs.get("emb_update_ms")
    return statistics.median(ms) if ms else None
