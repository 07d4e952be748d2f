"""The decode window's share of the card's float32 peak: the decoder
forward's operations of the window's decodes (``counters``) over the
summed time of its requests (``closed_loop``)."""


def read(obs):
    if obs.get("kind") != "decode" or not obs.get("decodes"):
        return None
    return 100.0 * obs["flops_per_decode"] * obs["decodes"] / obs["window_s"] / obs["peak_flops"]
