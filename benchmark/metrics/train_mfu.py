"""The training window's share of the card's peak in the compute dtype:
the conv chain's operations of the window's epochs (``counters``) over
its wall time."""


def read(obs):
    if obs.get("kind") != "train" or not obs.get("epochs"):
        return None
    return 100.0 * obs["flops_per_epoch"] * obs["epochs"] / obs["window_s"] / obs["peak_flops"]
