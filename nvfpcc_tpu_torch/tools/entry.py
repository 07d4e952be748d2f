"""The single-card forward check, the counterpart of ``__graft_entry__.entry``:
an eval forward of the flagship model (ch=3, chanstr 8,16,8,8) over all 917
blocks of the longdress_vox10 configuration.

``entry(device=None)`` returns ``(fn, (net, emb))``: ``fn(net, emb)`` is
``models.decoder.net_apply(net, emb, "eval", 2)`` without gradients,
returning ``(occupancy, net_bits, latent bits summed)``; ``net`` holds the
init params, ``emb`` the 917 ones embeddings. It runs on the card unless
``device="cpu"``.

    python -m nvfpcc_tpu_torch.tools.entry [--platform cpu]

runs ``fn`` once to warm up and once timed, and prints one JSON line: the
output shapes, whether the occupancy is finite, the bits, and the timed
forward's milliseconds (CUDA events on the card, the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from nvfpcc_tpu_torch.device import PLATFORMS, card_line, resolve_device, set_numerics
from nvfpcc_tpu_torch.models import decoder as M

N_BLOCKS, CH, CHANNELS = 917, 3, (8, 16, 8, 8)


def entry(device=None):
    """(fn, (net, emb)): the eval forward over all 917 flagship blocks, on
    the card (``device=None``, raises without one) or on ``device``."""
    device = resolve_device("default") if device is None else torch.device(device)
    # the codec's float math: TF32 off, so the card's forward is an f32 one
    set_numerics()
    spec = M.build_model_spec(ch=CH, channels=CHANNELS)
    net = M.init_params(spec, device)
    emb = M.init_embeddings(N_BLOCKS, CH, device)

    @torch.no_grad()
    def fn(net, emb):
        out, _, net_bits, latent_bits = M.net_apply(net, emb, "eval", 2)
        return out, net_bits, latent_bits.sum()

    return fn, (net, emb)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=PLATFORMS, default="default",
                    help="cpu: run on the host; default/device: the CUDA card, and fail without one")
    device = resolve_device(ap.parse_args(argv).platform)
    print(card_line(device), flush=True)
    fn, (net, emb) = entry(device)
    fn(net, emb)
    if device.type == "cuda":
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out, net_bits, lat_bits = fn(net, emb)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
    else:
        t0 = time.perf_counter()
        out, net_bits, lat_bits = fn(net, emb)
        ms = (time.perf_counter() - t0) * 1e3
    print(json.dumps({
        "out_shape": list(out.shape), "finite": bool(torch.isfinite(out).all()),
        "net_bits": net_bits.cpu().tolist(), "latent_bits": float(lat_bits), "forward_ms": ms,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
