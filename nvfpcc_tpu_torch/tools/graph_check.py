"""Graph = eager on the card: ``train`` with CUDA graphs and eagerly from
one init, under ``torch.use_deterministic_algorithms``, must give the same
bits (every parameter, the embeddings, both Adams' moments and steps, every
epoch's metric rows and the metrics lines). ``chip_smoke.py`` runs it on
the vox10 sphere in every training mode and ``tools/ctx_recipe.py`` on the
vox11 grids before its training stage.

Each run also reports its epoch seconds, its peak device bytes
(``torch.cuda.max_memory_allocated`` from a reset at its start) and the
seconds of each ``train.graphs.capture`` call by q phase, measured by
wrapping the trainer's ``run_epoch`` and ``capture`` (no trainer option).
Set ``CUBLAS_WORKSPACE_CONFIG`` (``:4096:8``) before CUDA starts, as
deterministic algorithms ask.
"""

from __future__ import annotations

import contextlib
import inspect
import os
import time

import numpy as np


def bits_equal(a: dict, b: dict) -> list:
    """The keys of two dicts of numpy arrays whose bytes differ (or that one lacks)."""
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].shape != b[k].shape or a[k].tobytes() != b[k].tobytes())


@contextlib.contextmanager
def recorded():
    """Within: every epoch's metric rows as ``train`` gets them from
    ``run_epoch`` (device tensors, ``rows``) and the seconds of every
    ``capture`` the trainer calls (synchronized before and after), listed
    under its q phase (``capture_s``: ``{"q1": [net step, embedding
    update], ...}``)."""
    import torch

    from nvfpcc_tpu_torch.train import loop as TT

    rec = {"rows": [], "capture_s": {}}
    real_epoch, real_capture = TT.run_epoch, TT.capture
    q_now = []

    def run_epoch(*a, **k):
        q_now[:] = [inspect.signature(real_epoch).bind(*a, **k).arguments["q"]]
        rec["rows"].append(real_epoch(*a, **k))
        return rec["rows"][-1]

    def capture(*a, **k):
        torch.cuda.synchronize()
        t = time.time()
        graph = real_capture(*a, **k)
        torch.cuda.synchronize()
        rec["capture_s"].setdefault(f"q{q_now[0]}", []).append(time.time() - t)
        return graph

    TT.run_epoch, TT.capture = run_epoch, capture
    try:
        yield rec
    finally:
        TT.run_epoch, TT.capture = real_epoch, real_capture


def graph_train_run(gt, dist, mcfg, cfg, graphs: bool, metrics_path: str, checkpoint_dir=None,
                    resume: bool = False) -> dict:
    """``train`` on the card from its init (or resumed from
    ``checkpoint_dir``) with CUDA graphs or eager: the state as numpy
    (every parameter, the embeddings, both Adams' moments and steps), every
    epoch's metric rows, the metrics lines, the log's epoch seconds, the
    run's seconds, its peak device bytes and its capture seconds."""
    import torch

    from nvfpcc_tpu_torch.train import loop as TT
    from nvfpcc_tpu_torch.utils.params import adam_state_to_numpy, flatten_tree, named_params, params_to_numpy

    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.time()
    with recorded() as rec:
        _, state = TT.train(gt, dist, mcfg, cfg, "cuda", log=lines.append, metrics_path=metrics_path,
                            checkpoint_dir=checkpoint_dir, resume=resume, graphs=graphs)
        torch.cuda.synchronize()
    secs = time.time() - t
    peak = torch.cuda.max_memory_allocated()
    arrays = {f"params/{k}": v for k, v in flatten_tree(params_to_numpy(state.net)).items()}
    arrays["emb"] = state.emb.detach().cpu().numpy()
    for name, opt, named in (("opt", state.opt, named_params(state.net)), ("emb_opt", state.emb_opt, {"emb": state.emb})):
        mu, nu, count = adam_state_to_numpy(opt, named)
        arrays.update({f"{name}/mu/{k}": v for k, v in mu.items()})
        arrays.update({f"{name}/nu/{k}": v for k, v in nu.items()})
        arrays[f"{name}/step"] = np.asarray(count)
    arrays["metric_rows"] = torch.stack(rec["rows"]).cpu().numpy()
    with open(metrics_path) as f:
        metric_lines = f.read().splitlines()
    epoch_s = [float(line.split("TRAIN ")[1].split("s]")[0]) for line in lines if " TRAIN " in line]
    return {"arrays": arrays, "metric_lines": metric_lines, "epoch_s": epoch_s, "train_s": secs,
            "peak_bytes": peak, "capture_s": rec["capture_s"], "state": state}


def graph_eager_pair(gt, dist, mcfg, cfg, workdir: str, name: str, first_cfg=None) -> tuple:
    """:func:`graph_train_run` with graphs, then eagerly, under
    deterministic algorithms; with ``first_cfg`` each side first trains
    ``first_cfg`` into a checkpoint dir of its own and the compared run
    resumes from its snapshot. Returns (the comparison: ``differ``, the
    array keys whose bytes differ, ``compared``, the count of arrays,
    ``metric_lines_equal``, and each side's seconds, peak bytes and capture
    seconds; the graph run's result)."""
    import torch

    runs = {}
    torch.use_deterministic_algorithms(True)
    try:
        for g in (True, False):
            tag = f"{name}_{'graphs' if g else 'eager'}"
            ck = os.path.join(workdir, f"{tag}_ckpt") if first_cfg is not None else None
            if first_cfg is not None:
                graph_train_run(gt, dist, mcfg, first_cfg, g, os.path.join(workdir, f"{tag}_first.jsonl"), ck)
            runs[g] = graph_train_run(gt, dist, mcfg, cfg, g, os.path.join(workdir, f"{tag}.jsonl"), ck,
                                      resume=first_cfg is not None)
    finally:
        torch.use_deterministic_algorithms(False)
    stats = {"differ": bits_equal(runs[True]["arrays"], runs[False]["arrays"]),
             "compared": len(runs[True]["arrays"]),
             "metric_lines_equal": runs[True]["metric_lines"] == runs[False]["metric_lines"]}
    for g in (True, False):
        side = "graphs" if g else "eager"
        stats.update({f"{k}_{side}": runs[g][k] for k in ("train_s", "epoch_s", "peak_bytes")})
    stats["capture_s"] = runs[True]["capture_s"]
    stats["equal"] = not stats["differ"] and stats["metric_lines_equal"]
    return stats, runs[True]
