"""State carried across packages: the JAX params tree <-> the port's modules.

The JAX package keeps its params as a nested dict of arrays
(``{"decoder": {"up0": {"kernel": ...}}}``, kernels DHWIO). The port's
modules name their parameters by the same paths with ``.`` for ``/``, in the
same layouts, so the mapping is a rename and a copy; the ctx family's
entropy subtree (``entropy/ctx1/kernel`` ...) maps to ``Net.entropy``, a
``CtxPredictor``, the same way. An Adam state crosses
the same way: optax's ``mu``/``nu`` trees and ``count`` are
``torch.optim.Adam``'s ``exp_avg``/``exp_avg_sq`` and ``step``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> ``{"a/b/c": leaf}``."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(flatten_tree(value, path))
        else:
            flat[path] = value
    return flat


def unflatten_tree(flat: dict) -> dict:
    """``{"a/b/c": leaf}`` -> nested dict."""
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def params_from_numpy(module: nn.Module, tree: dict, strict: bool = True) -> nn.Module:
    """Copy a numpy params tree into ``module``'s parameters (in place, on
    the module's device). Every leaf must name a parameter; with ``strict``
    every parameter must be given (``strict=False`` loads a decode-minimal
    tree, leaving the training-only leaves at their init)."""
    own = dict(module.named_parameters())
    flat = flatten_tree(tree)
    unknown = [k for k in flat if k.replace("/", ".") not in own]
    if unknown:
        raise KeyError(f"params tree has leaves the model does not: {unknown}")
    if strict:
        missing = [k for k in own if k.replace(".", "/") not in flat]
        if missing:
            raise KeyError(f"params tree lacks {missing}")
    with torch.no_grad():
        for key, value in flat.items():
            p = own[key.replace("/", ".")]
            v = torch.from_numpy(np.array(value, dtype=np.float32, copy=True))
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(v.shape)} != model {tuple(p.shape)}")
            p.copy_(v)
    return module


def params_to_numpy(module: nn.Module) -> dict:
    """``module``'s parameters as a nested numpy float32 tree (JAX layout)."""
    return unflatten_tree({
        name.replace(".", "/"): p.detach().cpu().numpy().astype(np.float32)
        for name, p in module.named_parameters()
    })


def adam_state_to_numpy(opt: torch.optim.Adam, named: dict):
    """``(mu, nu, count)`` of an Adam over the tensors ``named`` (``{"a/b":
    tensor}``): flat dicts of numpy float32 first and second moments, and
    the number of updates made. A tensor that was never stepped reads as
    zeros."""
    mu, nu, counts = {}, {}, set()
    for key, p in named.items():
        st = opt.state.get(p, {})
        zeros = np.zeros(tuple(p.shape), np.float32)
        mu[key] = st["exp_avg"].detach().cpu().numpy() if st else zeros
        nu[key] = st["exp_avg_sq"].detach().cpu().numpy() if st else zeros.copy()
        counts.add(int(st["step"]) if st else 0)
    if len(counts) != 1:
        raise ValueError(f"Adam step counts differ between tensors: {sorted(counts)}")
    return mu, nu, counts.pop()


def adam_state_from_numpy(opt: torch.optim.Adam, named: dict, mu: dict, nu: dict, count: int) -> None:
    """Set the Adam state of the tensors ``named`` from flat numpy moments
    and the update count (the inverse of :func:`adam_state_to_numpy`)."""
    if set(mu) != set(named) or set(nu) != set(named):
        raise KeyError("Adam moments do not name the optimizer's tensors")
    for key, p in named.items():
        def like(a):
            a = np.array(a, dtype=np.float32, copy=True)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{key}: moment shape {a.shape} != {tuple(p.shape)}")
            return torch.from_numpy(a).to(p.device)

        # the step is a host scalar, as torch.optim.Adam keeps it by default
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": like(mu[key]),
            "exp_avg_sq": like(nu[key]),
        }


def named_params(module: nn.Module) -> dict:
    """``{"a/b/c": parameter}`` in the JAX tree's path names."""
    return {name.replace(".", "/"): p for name, p in module.named_parameters()}
