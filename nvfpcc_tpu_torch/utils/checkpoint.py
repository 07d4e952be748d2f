"""npz checkpoints in the JAX package's flat-key layout (port of
``nvfpcc_tpu/utils/checkpoint.py``): one ``.npz`` per epoch with
'/'-joined params paths, the embeddings under ``__emb__`` and a JSON meta
dict under ``__meta__``. A JAX checkpoint loads here and vice versa.

Train-state snapshots (``state_NNNN.npz``: params, both Adams' moments and
step counts, embeddings, epoch) are the port's own flat npz with no pickle.
They do not cross packages: the JAX package pickles an optax treedef into
its snapshots, which cannot be read without jax. The per-epoch checkpoints
above do cross, both ways."""

from __future__ import annotations

import json
import os
import re

import numpy as np

from nvfpcc_tpu_torch.utils.params import (
    adam_state_from_numpy, adam_state_to_numpy, flatten_tree, named_params, params_from_numpy,
    params_to_numpy, unflatten_tree,
)


def save_checkpoint(directory: str, epoch: int, params: dict, emb, meta=None) -> str:
    """``params``: numpy tree (see ``utils.params.params_to_numpy``)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{epoch:04d}.npz")
    extra = {}
    if meta is not None:
        extra["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), np.uint8)
    flat = {k: np.asarray(v) for k, v in flatten_tree(params).items()}
    np.savez(path, **flat, __emb__=np.asarray(emb), **extra)
    return path


def load_checkpoint(path: str):
    """Returns (params tree, emb array)."""
    params, emb, _ = load_checkpoint_meta(path)
    return params, emb


def load_checkpoint_meta(path: str):
    """Returns (params tree, emb array or None, meta dict or None)."""
    with np.load(path) as npz:
        data = dict(npz)
    emb = data.pop("__emb__", None)
    meta = data.pop("__meta__", None)
    if meta is not None:
        meta = json.loads(meta.tobytes().decode("utf-8"))
    return unflatten_tree(data), emb, meta


def latest_checkpoint(directory: str):
    if not os.path.isdir(directory):
        return None
    files = [f for f in os.listdir(directory) if re.fullmatch(r"\d{4}\.npz", f)]
    if not files:
        return None
    return os.path.join(directory, max(files))


def save_train_state(directory: str, epoch: int, state, emb_state=None) -> str:
    """Full resumable snapshot of a ``train.loop.TrainState``. ``emb_state``
    (embeddings, their Adam moments ``exp_avg``, ``exp_avg_sq`` and step
    count, numpy, the whole block axis) replaces the state's own: a block-DP
    rank holds only its rows, and ``train`` gathers them first."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"state_{epoch:04d}.npz")
    mu, nu, count = adam_state_to_numpy(state.opt, named_params(state.net))
    if emb_state is None:
        emu, enu, ecount = adam_state_to_numpy(state.emb_opt, {"emb": state.emb})
        emb_state = (state.emb.detach().cpu().numpy(), emu["emb"], enu["emb"], ecount)
    emb, emu, enu, ecount = emb_state
    flat = {f"params/{k}": v for k, v in flatten_tree(params_to_numpy(state.net)).items()}
    flat.update({f"opt/exp_avg/{k}": v for k, v in mu.items()})
    flat.update({f"opt/exp_avg_sq/{k}": v for k, v in nu.items()})
    np.savez(
        path, **flat, **{"opt/step": np.int64(count), "emb": emb,
                         "emb_opt/exp_avg": emu, "emb_opt/exp_avg_sq": enu,
                         "emb_opt/step": np.int64(ecount), "epoch": np.int64(epoch)},
    )
    return path


def load_train_state(path: str) -> dict:
    """The snapshot as nested numpy: ``params``, ``opt`` (``exp_avg``,
    ``exp_avg_sq``, ``step``), ``emb``, ``emb_opt`` and ``epoch``."""
    with np.load(path, allow_pickle=False) as npz:
        tree = unflatten_tree(dict(npz))
    for key in ("opt", "emb_opt"):
        tree[key]["step"] = int(tree[key]["step"])
    tree["epoch"] = int(tree["epoch"])
    return tree


def restore_train_state(state, snap: dict) -> None:
    """Copy a loaded snapshot into ``state`` (in place, on its device)."""
    import torch

    params_from_numpy(state.net, snap["params"])
    o = snap["opt"]
    adam_state_from_numpy(
        state.opt, named_params(state.net), flatten_tree(o["exp_avg"]),
        flatten_tree(o["exp_avg_sq"]), o["step"],
    )
    with torch.no_grad():
        state.emb.copy_(torch.from_numpy(np.array(snap["emb"], np.float32)))
    e = snap["emb_opt"]
    adam_state_from_numpy(
        state.emb_opt, {"emb": state.emb}, {"emb": e["exp_avg"]}, {"emb": e["exp_avg_sq"]},
        e["step"],
    )
    state.epoch = snap["epoch"]


def latest_train_state(directory: str):
    if not os.path.isdir(directory):
        return None
    files = [f for f in os.listdir(directory) if re.fullmatch(r"state_\d{4}\.npz", f)]
    if not files:
        return None
    return os.path.join(directory, max(files))
