"""The port's ctx-mode latent decoder: ``coder/ctx_coder.py``'s decode,
computing each value the coding steps read once.

``ctx_coder.decode_latents_ctx`` (a byte-equal copy of the JAX package's
file) runs its :class:`~nvfpcc_tpu_torch.coder.ctx_coder.ExactPredictor`
over every position and output of every block at each of its 8, or 8 * ch,
steps, keeps one position's one or ch channels of the outputs (1/24 of them
in ``ctx_ar`` at ch 3), and builds each step's tables anew for every
stream. Here:

- a hidden unit is computed once, at the first step whose outputs read it
  through a nonzero layer-2 tap; the masks make its inputs all decoded by
  then (checked when the plan is made), so it never changes again;
- a step computes only its own outputs, from the hidden units computed so
  far, on the decode's device (its matmuls in float64; the range decoder
  and the tables stay on the host);
- a (sigma level, mu fraction) table is built once in the process: it is a
  function of its key alone, and there are 4,096 keys.

The sums are the same integers in float64 under ``ExactPredictor``'s 2^53
bound (every sum of such integers is exact and order-free, on any IEEE
float64 unit), and past it the steps take the full predictor's integers.
The tables and the symbols read are the copy's, bit for bit
(``tests/test_torch_ctx_steps.py``).
"""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import numpy as np
import torch

from nvfpcc_tpu_torch.coder import ctx_coder as CTX
from nvfpcc_tpu_torch.coder import range_coder as RC
from nvfpcc_tpu_torch.utils import trace

N_KEYS = CTX.SIGMA_LEVELS * CTX.MU_GRID  # table key: sigma_idx * MU_GRID + mu_frac


class StepPredictor:
    """The coding steps' ``(mu16, sigma_idx)``, each (N, k) int64 for the
    step's k channels: ``ExactPredictor(ints)(x)[..][:, z, y, w, csel]``.
    Call it for steps 0, 1, ... in turn on one decode's latents ``x``,
    filled through the step before; the matmuls run on ``device``."""

    def __init__(self, ints: Dict[str, np.ndarray], ch: int, channel_ar: bool, device="cpu"):
        self._full = CTX.ExactPredictor(ints)
        self.steps = CTX._steps(ch, channel_ar)
        w1, w2 = CTX._dense_from_kernel(ints["K1"]), CTX._dense_from_kernel(ints["K2"])
        self._colsum1 = int(np.abs(w1).sum(axis=0).max(initial=0))
        self._colsum2 = int(np.abs(w2).sum(axis=0).max(initial=0))
        self._b1max = int(np.abs(ints["b1"]).max(initial=0))
        self._b2max = int(np.abs(ints["b2"]).max(initial=0)) * CTX.KSCALE
        b1 = np.tile(np.asarray(ints["b1"], np.int64), 8)
        b2 = np.tile(np.asarray(ints["b2"], np.int64), 8) * CTX.KSCALE
        cout = int(ints["K2"].shape[4])

        def f64(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=device)

        # per step: (decoded inputs, new hidden units' layer 1 and biases,
        # hidden units read, the outputs' layer 2 and biases); hidden units
        # are kept in the order they are first read
        self._plans, order, done = [], [], np.zeros(w2.shape[0], bool)
        for s, (z, y, w, csel) in enumerate(self.steps):
            pos = 4 * z + 2 * y + w
            k = pos * ch + (s % ch if channel_ar else 0)  # x's columns decode in order
            mu = pos * cout + np.arange(ch)[csel]
            cols = np.concatenate([mu, mu + ch])  # mu first, then sigma: _pred_outputs' order
            rows = np.flatnonzero(np.any(w2[:, cols] != 0, axis=1))
            new = rows[~done[rows]]
            if np.any(w1[k:, new]):
                raise ValueError(f"ctx step {s} reads a hidden unit of a latent it has not decoded")
            done[new] = True
            order.extend(new.tolist())
            self._plans.append((k, f64(w1[:k, new]), f64(b1[new]), len(order),
                                f64(w2[np.ix_(order, cols)]), f64(b2[cols])))
        self._device = device
        self._x = self._h = None
        self._k = 0  # latents' columns on the device
        self._xmax = 0
        self._step = 0

    def __call__(self, x_int: np.ndarray):
        s = self._step
        self._step += 1
        z, y, w, csel = self.steps[s]
        k, w1, b1, end, w2, b2 = self._plans[s]
        n = x_int.shape[0]
        if self._x is None:
            self._x = torch.zeros((n, x_int[0].size), dtype=torch.float64, device=self._device)
            self._h = torch.empty((n, self._plans[-1][3]), dtype=torch.float64, device=self._device)
        if k > self._k:  # the columns decoded since the last step
            cols = x_int.reshape(n, -1)[:, self._k : k]
            self._xmax = max(self._xmax, int(np.abs(cols).max(initial=0)))
            self._x[:, self._k : k] = torch.as_tensor(cols.astype(np.float64), device=self._device)
            self._k = k
        bound1 = self._xmax * self._colsum1 + self._b1max
        if max(bound1, bound1 * self._colsum2 + self._b2max) >= (1 << 53):
            mu16, sidx = self._full(x_int)
            return mu16[:, z, y, w, csel], sidx[:, z, y, w, csel]
        start = end - w1.shape[1]
        if end > start:
            pre1 = self._x[:, :k] @ w1 + b1
            # leaky slope 1/16, floored: ExactPredictor's exact float rule
            self._h[:, start:end] = torch.where(pre1 >= 0, pre1, torch.floor(pre1 * (1.0 / CTX.MU_GRID)))
        out = (self._h[:, :end] @ w2 + b2).to(torch.int64).cpu().numpy()
        return CTX._pred_outputs(out)


_TABLES = {"cum": None, "built": None, "lock": threading.Lock()}


def _tables_with(keys: np.ndarray) -> np.ndarray:
    """The process's (N_KEYS, N_SYM + 1) cumulative tables, one row a key,
    with every row of ``keys`` built (``ctx_coder._tables_for_keys``, row
    by row the same); row 0 always, since the native decoder reads the
    tables' total from it."""
    with _TABLES["lock"]:
        if _TABLES["cum"] is None:
            _TABLES["cum"] = np.zeros((N_KEYS, RC.N_SYM + 1), np.uint32)
            _TABLES["built"] = np.zeros(N_KEYS, bool)
            keys = np.append(keys, 0)
        missing = np.unique(keys[~_TABLES["built"][keys]])
        if len(missing):
            _TABLES["cum"][missing] = CTX._tables_for_keys(missing, {})
            _TABLES["built"][missing] = True
        return _TABLES["cum"]


def decode_latents_ctx(
    stream: bytes,
    shape: Tuple[int, ...],
    ints: Dict[str, np.ndarray],
    channel_ar: bool = False,
    device="cpu",
) -> np.ndarray:
    """``ctx_coder.decode_latents_ctx``: the same steps, tables and
    symbols, each step's predictions from :class:`StepPredictor` on
    ``device``. Counts the distinct tables the stream used
    (``trace.count``)."""
    x = np.zeros(shape, np.int64)
    pred = StepPredictor(ints, shape[-1], channel_ar, device)
    used = np.zeros(N_KEYS, bool)
    with RC.StreamingDecoder(stream) as dec:
        for z, y, w, csel in pred.steps:
            m, sidx = pred(x)
            shift = m >> 4
            keys = (sidx * CTX.MU_GRID + (m & (CTX.MU_GRID - 1))).reshape(-1)
            used[keys] = True
            syms = dec.decode(keys.astype(np.int32), _tables_with(keys)).astype(np.int64)
            x[:, z, y, w, csel] = syms.reshape(shift.shape) - RC.OFFSET + shift
    trace.count(tables=int(used.sum()))
    return x
