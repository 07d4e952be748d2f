"""Median milliseconds of an epoch's net steps (``EpochProgram.net_steps``:
forward, backward and Adam of every batch), CUDA events around the call."""

import statistics


def read(obs):
    ms = obs.get("net_steps_ms")
    return statistics.median(ms) if ms else None
