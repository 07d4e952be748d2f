"""Median over the profiled decodes of the host milliseconds a decode
spends rebuilding its decoder: the program's ``codec.decoder`` span
(``decoder_from_tree``: the seeded modules built, the pack's weights set
and copied to the device). None without the program's spans."""

import statistics

SPAN, FIELD = "codec.decoder", "host_ms"


def read(obs):
    if obs.get("kind") != "decode" or not obs.get("stretch_decodes"):
        return None
    try:
        from nvfpcc_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    per_request = [v[FIELD] for r, v in trace.summary(SPAN).items() if r is not None]
    last = per_request[-int(obs["stretch_decodes"]):]
    if not last or any(v is None for v in last):
        return None
    return statistics.median(last)
