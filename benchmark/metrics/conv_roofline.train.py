"""The least time the card could take for the conv chain's work of the
profiled epochs (the larger of operations over peak and bytes over
bandwidth, ``counters``) over the device's busy time in them."""


def read(obs):
    if obs.get("kind") != "train" or not obs.get("stretch_busy_s"):
        return None
    return 100.0 * obs["least_s_per_epoch"] * obs["stretch_epochs"] / obs["stretch_busy_s"]
