"""Median over the profiled decodes of the host milliseconds a decode
spends in the ctx coder: the program's ``codec.latents.ctx`` span (the
ctx payload's integers rebuilt, then 8 or 8 * ch sequential steps, each a
prediction of every block, the tables it lacks and its symbols from one
range decoder). None for a run of another kind, for a decode whose pack
is not in a ctx mode, and without the program's spans."""

import statistics

SPAN, FIELD = "codec.latents.ctx", "host_ms"


def read(obs):
    if obs.get("kind") != "decode" or not obs.get("stretch_decodes"):
        return None
    try:
        from nvfpcc_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    per_request = [v[FIELD] for r, v in trace.summary(SPAN).items() if r is not None]
    last = per_request[-int(obs["stretch_decodes"]):]
    return statistics.median(last) if last else None
