"""The share of the profiled decodes' wall time in which no operation ran
on the device."""


def read(obs):
    if obs.get("kind") != "decode" or not obs.get("stretch_s"):
        return None
    return 100.0 * (1.0 - obs["stretch_busy_s"] / obs["stretch_s"])
