"""Median over the profiled decodes of the share (%) of a decode's host
time that its ctx coder takes: the program's ``codec.latents.ctx`` host
ms over the same decode's ``codec.decode`` host ms. The coder runs on the
host before the first reconstruction batch, so the share says whether the
coder or the reconstruction sets a decode's pace. None for a run of
another kind, for a decode whose pack is not in a ctx mode, and without
the program's spans."""

import statistics


def read(obs):
    if obs.get("kind") != "decode" or not obs.get("stretch_decodes"):
        return None
    try:
        from nvfpcc_tpu_torch.utils import trace
    except ImportError:  # a program without spans
        return None
    decodes = trace.summary("codec.decode")
    shares = [100.0 * v["host_ms"] / decodes[r]["host_ms"] for r, v in trace.summary("codec.latents.ctx").items()
              if r is not None and decodes.get(r, {}).get("host_ms")]
    last = shares[-int(obs["stretch_decodes"]):]
    return statistics.median(last) if last else None
