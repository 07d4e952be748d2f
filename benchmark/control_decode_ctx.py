"""The control and the planted coder fault of ``decode.ctx_vox11``, at the
cell's own size, beside the program's own reading: what ``point_gap``
reads on the cell's first frame of each seed (``drivers/decode_ctx.py``)
when

- ``program``: the program decodes the pack (a sound reading);
- ``control_tf32``: the reference reconstructs the frame's latents with its
  convs' operands rounded to TF32, the nearest precision below the
  configuration's float32;
- ``coder_fault``: one decoded latent of one step is shifted by 1
  (:func:`plant`) and the reference reconstructs the latents so decoded.

The smallest control and fault readings are the upper end the cell's
limit is set under; the largest program reading its lower end.

    python3 -m benchmark.control_decode_ctx --seeds 1,2,3 [--out FILE]

One JSON line per seed and kind.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmark.harness import Registry

CELL = "decode.ctx_vox11"
# block 0, position (1, 1, 1) (the last in raster order), the last channel:
# the latent of the last of the 8 * ch decode steps, which no later
# prediction reads, so the fault stays one latent
FAULT = (0, 1, 1, 1, -1)


def plant(latents: np.ndarray) -> np.ndarray:
    """The latents with the one at :data:`FAULT` shifted by 1."""
    out = np.array(latents, copy=True)
    out[FAULT] += 1
    return out


def readings(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """{kind: point_gap} on the first frame the cell makes from ``seed``."""
    from benchmark.drivers.decode import occupancy
    from benchmark.drivers.decode_ctx import decoder_model, pack_frame
    from benchmark.reference import compare
    from nvfpcc_tpu_torch import codec

    dev = torch.device(device)
    model = decoder_model(cfg, dev)
    pack, fr = pack_frame(cfg, traffic, model, np.random.default_rng(seed), dev, log=lambda s: None)
    origins, thh = fr["origins"], fr["thh"]
    ref = occupancy(model, fr["params"], fr["latents"], dev).cpu().numpy()

    def points_of(occ):
        idx = np.argwhere(occ > np.float32(thh))
        return idx[:, 1:] + origins[idx[:, 0]]

    sides = {
        "program": codec.decode(pack, dev)[0],
        "control_tf32": points_of(occupancy(model, fr["params"], fr["latents"], dev, precision="tf32").cpu().numpy()),
        "coder_fault": points_of(occupancy(model, fr["params"], plant(fr["latents"]), dev).cpu().numpy()),
    }
    return {kind: compare.point_gap(pts, origins, ref, thh)[0] for kind, pts in sides.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    reg = Registry()
    cell = reg.cell(CELL)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        for kind, value in readings(cfg, traffic, seed, dev).items():
            line = json.dumps({"workload": CELL, "seed": seed, "kind": kind, "numbers": value})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
