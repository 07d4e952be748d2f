"""CPU dry run of block-DP training: one ``train`` epoch on an n-rank gloo
group at tiny shapes, through the same ``parallel.run_group`` and
``train(mesh=...)`` a multi-card run takes.

Two configs run as two jobs of one group:

- the toy model (ch=2, chanstr 4,8,4,4) on n + 3 blocks: an uneven count,
  so the padding rows and the block mask are exercised, several batches;
- the flagship spec (ch=3, chanstr 8,16,8,8) on one block per rank.

Each prints one OK line once its checks pass: finite losses, one TRAIN line
from rank 0, every rank ending with the same params and all the real
blocks' embeddings. Any failure raises.

    python -m nvfpcc_tpu_torch.tools.dryrun_multichip --ranks 8
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.parallel import run_group
from nvfpcc_tpu_torch.train.loop import train_on_mesh
from nvfpcc_tpu_torch.utils.params import flatten_tree


def configs(n_ranks: int) -> list:
    """(model config, block count, batch size) of each dry-run job."""
    return [
        (ModelConfig(ch=2, chanstr="4,8,4,4"), n_ranks + 3, 4),
        (ModelConfig(ch=3, chanstr="8,16,8,8"), n_ranks, 4),
    ]


def dryrun(n_ranks: int) -> list:
    """Run both configs on one ``n_ranks`` group; returns the OK lines."""
    rng = np.random.default_rng(0)
    chosen = configs(n_ranks)
    jobs = []
    for mcfg, n_blocks, batch in chosen:
        gt = (rng.uniform(0, 1, (n_blocks, 32, 32, 32)) < 0.02).astype(np.uint8)
        dist = (rng.uniform(0, 5, gt.shape) * (1 - gt)).astype(np.float32)
        jobs.append(dict(gt=gt, dist=dist, model_cfg=mcfg,
                         cfg=TrainConfig(epochs=1, phase_change=1, batch_size=batch, eval_every=0)))
    ranks = run_group(train_on_mesh, n_ranks, "gloo", ["cpu"] * n_ranks, args=(jobs,))
    lines = []
    for j, (mcfg, n_blocks, _) in enumerate(chosen):
        got = [r[j] for r in ranks]
        train_lines = [x for x in got[0]["log"] if " TRAIN " in x]
        if len(train_lines) != 1 or "nan" in train_lines[0].lower() or any(r["log"] for r in got[1:]):
            raise RuntimeError(f"unexpected log lines: {[r['log'] for r in got]}")
        p0 = flatten_tree(got[0]["params"])
        for r in got[1:]:
            if not all(np.array_equal(v, p0[k]) for k, v in flatten_tree(r["params"]).items()):
                raise RuntimeError("params differ between ranks")
            if not np.array_equal(r["emb"], got[0]["emb"]):
                raise RuntimeError("embeddings differ between ranks")
        if got[0]["emb"].shape != (n_blocks, 2, 2, 2, mcfg.ch) or not np.isfinite(got[0]["emb"]).all():
            raise RuntimeError(f"embeddings {got[0]['emb'].shape}, finite {np.isfinite(got[0]['emb']).all()}")
        lines.append(f"dryrun_multichip({n_ranks}): OK ch={mcfg.ch} chanstr {mcfg.chanstr}, "
                     f"{n_blocks} blocks over {n_ranks} gloo ranks, {got[0]['seconds']:.1f}s")
        print(lines[-1], flush=True)
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8)
    dryrun(ap.parse_args().ranks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
