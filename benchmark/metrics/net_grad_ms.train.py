"""Median over the profiled epochs of the device milliseconds an epoch's
net gradients take: the program's ``train.net_grad`` spans (one CUDA
graph replay, or one eager forward and backward, per batch), summed per
epoch. None without the program's spans, or without device times (the CPU)."""

import statistics

SPAN, FIELD = "train.net_grad", "device_ms"


def read(obs):
    if obs.get("kind") != "train" or not obs.get("stretch_epochs"):
        return None
    try:
        from nvfpcc_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    per_request = [v[FIELD] for r, v in trace.summary(SPAN).items() if r is not None]
    last = per_request[-int(obs["stretch_epochs"]):]
    if not last or any(v is None for v in last):
        return None
    return statistics.median(last)
