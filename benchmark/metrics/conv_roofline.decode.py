"""The least time the card could take for the f32 conv chain's work of
the profiled decodes (``counters``) over the device's busy time inside
their ``reconstruct_points`` spans."""


def read(obs):
    if obs.get("kind") != "decode" or not obs.get("recon_busy_s"):
        return None
    return 100.0 * obs["least_s_per_decode"] * obs["stretch_decodes"] / obs["recon_busy_s"]
