"""Median over the profiled decodes of the device milliseconds a decode's
reconstruction forwards take: the program's ``codec.recon.forward`` spans
(a batch's upload and the decoder's forward), summed per decode. None
without the program's spans, or without device times (the CPU)."""

import statistics

SPAN, FIELD = "codec.recon.forward", "device_ms"


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
