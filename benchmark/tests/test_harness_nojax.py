"""What a run loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``nvfpcc_tpu`` (whole names: the program's own
name begins with the JAX package's), and the reference nothing of the
program."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RUN = r'''
import copy, json, sys, torch
torch.set_num_threads(2)
from benchmark.harness import Registry
from benchmark.run import execute
reg = Registry()
cell = reg.cell("decode.flagship_vox10")
cfg = copy.deepcopy(reg.config(cell["config"]))
cfg["n_blocks"], cfg["n_points"] = 8, 5000
execute(reg, cell, 5, 0.2, False, torch.device("cpu"), config=cfg, info={"platform": "cpu"})
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''

REFERENCE = r'''
import json, sys, torch
from benchmark import control, counters, generators, tracing
from benchmark.reference import compare, nvfpcc, seeds, train_ref
cfg = {"ch": 3, "chanstr": "8,16,8,8", "entropy_mode": "ctx", "ctx_hidden": 8, "n_blocks": 32,
       "train": {"lmbda": 200.0, "w1": 10.0, "w2": 57.0, "lr": 1e-3, "batch_size": 16, "focal_alpha": 0.9,
                 "ms_alpha": 0.85, "beta": 1.0, "emb_chunks": 2, "compute_dtype": "bf16", "wemb": 5.0,
                 "milestones": [300, 400, 450], "lr_decay": 0.1}}
gt, dist = generators.training_grids(1, 32, "cpu")
ref = train_ref.follow_steps(cfg, gt, dist, 1, 2, "bf16")
train_ref.full_set_emb_grad(cfg, ref["params"], gt, dist, 1, "bf16")
zeros = {k: torch.zeros_like(v) for k, v in ref["params"].items()}
emb = torch.ones(32, 2, 2, 2, 3)
rec = {"steps": [{"theta": ref["params"], "m": zeros, "v": zeros, "t": 2.0}], "theta_end": ref["params"],
       "emb": emb, "emb_m": 0 * emb, "emb_v": 0 * emb, "emb_t": 1.0}
train_ref.epoch_steps(cfg, gt, dist, 1, 1, rec, "bf16")
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
'''


def loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = loaded(RUN)
    assert "nvfpcc_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "nvfpcc_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    names = loaded(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "nvfpcc_tpu", "nvfpcc_tpu_torch"}
