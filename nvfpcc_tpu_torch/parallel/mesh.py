"""Block-data-parallel training over a ``torch.distributed`` group (port of
``nvfpcc_tpu/parallel/mesh.py``).

All N leaf blocks are independent given the shared decoder, so the block
axis is the one to split:

- per-block arrays (embeddings, gt/dist grids, the embeddings' Adam
  moments) are cut into contiguous row slices, one per rank, as JAX's
  ``P("blocks")`` lays them out (:meth:`Mesh.rows`);
- the decoder params and their Adam state are replicated: every rank takes
  the same Adam step on the same summed gradient.

JAX has GSPMD insert the decoder-gradient psum; here one process runs per
rank and ``train.loop`` all-reduces the gradients itself, one flat bucket
per net step (:meth:`Mesh.all_reduce`). The block axis is padded to a
multiple of the world size (:func:`pad_blocks`) and the padding rows are
masked out of every loss term.

A group is joined from ``torchrun``'s environment (:func:`init_distributed`)
or started in this process by :func:`run_group`, which runs rank 0 here and
the other ranks in spawned processes. The backend is NCCL on CUDA devices
and gloo on the CPU; gloo also takes CUDA tensors, which is how two ranks
share one card (NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

BLOCK_AXIS = "blocks"

# how long a rank waits in the group's rendezvous or in one collective
# before the run fails (a rank that died leaves the others waiting)
DEFAULT_TIMEOUT_S = 600.0

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@dataclass
class Mesh:
    """One rank's view of a 1-D ``blocks`` group: its rank, the world size,
    its device and the group's backend. It times the collectives a caller
    marks as timed (CUDA events on a card, the host clock on the CPU)."""

    rank: int
    world: int
    device: torch.device
    backend: str
    _timed: list = field(default_factory=list, repr=False)

    def rows(self, n_padded: int) -> slice:
        """This rank's contiguous slice of a padded block axis."""
        if n_padded % self.world:
            raise ValueError(
                f"block axis {n_padded} not divisible by world size {self.world}; "
                "pad with pad_blocks first"
            )
        per = n_padded // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, t: torch.Tensor, op: str = "sum", timed: bool = False) -> torch.Tensor:
        """``t`` reduced over the group, in place; returns ``t``."""
        cuda = t.is_cuda
        if timed:
            start = torch.cuda.Event(enable_timing=True) if cuda else time.perf_counter()
            if cuda:
                start.record()
        dist.all_reduce(t, op=_OPS[op])
        if timed:
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self._timed.append((start, end))
            else:
                self._timed.append((time.perf_counter() - start) * 1e3)
        return t

    def timed_ms(self) -> list:
        """Milliseconds of each timed collective since the last call (waits
        for the device)."""
        timed, self._timed = self._timed, []
        if any(isinstance(x, tuple) for x in timed):
            torch.cuda.synchronize(self.device)
        return [x[0].elapsed_time(x[1]) if isinstance(x, tuple) else x for x in timed]


def padded_block_count(n_blocks: int, world: int) -> int:
    """``n_blocks`` rounded up to a multiple of the world size."""
    return -(-n_blocks // world) * world


def pad_blocks(arr: np.ndarray, n_padded: int) -> np.ndarray:
    """Zero-pad axis 0 up to ``n_padded`` rows (host)."""
    n = arr.shape[0]
    if n == n_padded:
        return arr
    pad = np.zeros((n_padded - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, pad])


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def make_mesh(device) -> Mesh:
    """The mesh of this process in the initialized default group, on
    ``device`` (a rank's device is ``cuda:{LOCAL_RANK}`` under torchrun)."""
    device = torch.device(device)
    return Mesh(dist.get_rank(), dist.get_world_size(), device, _backend(device))


def init_distributed(device_type: str = "cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """Join the group ``torchrun`` describes in the environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL
    on ``cuda:{LOCAL_RANK}``, gloo on the CPU. Returns this rank's mesh."""
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    device = torch.device(f"cuda:{local}" if device_type == "cuda" else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        _backend(device), init_method="env://", rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]), timeout=datetime.timedelta(seconds=timeout_s),
    )
    return make_mesh(device)


def under_torchrun() -> bool:
    """True in a process that ``torchrun`` started (it sets RANK and WORLD_SIZE)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def shard_train_arrays(mesh: Mesh, *arrays) -> list:
    """This rank's rows of each block-axis host array (axis 0 already padded
    to a multiple of the world size), moved to the rank's device; the other
    ranks' rows never leave the host."""
    rows = mesh.rows(int(arrays[0].shape[0]))
    out = []
    for a in arrays:
        if a.shape[0] != arrays[0].shape[0]:
            raise ValueError(f"block axes differ: {a.shape[0]} != {arrays[0].shape[0]}")
        out.append(torch.as_tensor(np.ascontiguousarray(a[rows]), device=mesh.device))
    return out


def replicate(mesh: Mesh, module: torch.nn.Module) -> None:
    """Broadcast ``module``'s parameters from rank 0 (one flat bucket), so
    every rank starts from rank 0's values."""
    params = list(module.parameters())
    with torch.no_grad():
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, src=0)
        for p, v in zip(params, flat.split([p.numel() for p in params])):
            p.copy_(v.view_as(p))


def gather_rows(mesh: Mesh, local: torch.Tensor, n_padded: int) -> torch.Tensor:
    """The whole padded block axis on every rank: each rank's rows placed in
    zeros and summed over the group (exact: every element has one nonzero
    term). An all-reduce, so both backends take it on either device."""
    full = local.new_zeros((n_padded,) + tuple(local.shape[1:]))
    full[mesh.rows(n_padded)] = local.detach()
    return mesh.all_reduce(full)


def _run_rank(fn, rank, world, backend, device, init_method, timeout_s, args, kwargs):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    try:
        return fn(Mesh(rank, world, device, backend), *args, **kwargs)
    finally:
        dist.destroy_process_group()


def _child(fn, rank, world, backend, device, init_method, timeout_s, args, kwargs, results):
    try:
        out = _run_rank(fn, rank, world, backend, device, init_method, timeout_s, args, kwargs)
        results.put((rank, True, out))
    except BaseException:  # reported to rank 0's process, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def run_group(
    fn: Callable, world: int, backend: str, devices: Sequence, args=(), kwargs=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> list:
    """Run ``fn(mesh, *args, **kwargs)`` on every rank of a new ``world``-rank
    group and return the ranks' results in rank order.

    Rank 0 runs in this process (its output is this process's); ranks 1..
    are spawned processes (``fn`` and the arguments are pickled, so ``fn``
    is a module-level function of an importable module). ``devices[r]`` is
    rank r's device. The group meets in a file store in a temporary
    directory, so no port is taken. A rank that raises fails the call with
    its traceback; the other ranks' collectives then fail by ``timeout_s``.
    """
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    kwargs = kwargs or {}
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="nvfpcc_group_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [
            ctx.Process(
                target=_child, daemon=True,
                args=(fn, r, world, backend, str(devices[r]), init_method, timeout_s, args, kwargs,
                      results),
            )
            for r in range(1, world)
        ]
        for p in procs:
            p.start()
        try:
            out0 = _run_rank(fn, 0, world, backend, str(devices[0]), init_method, timeout_s, args,
                             kwargs)
        except BaseException:
            errors = _drain(results, len(procs), 5.0)
            for p in procs:
                p.kill()
                p.join(10)
            failed = [msg for ok, msg in errors.values() if not ok]
            if failed:
                raise RuntimeError("a rank of the group failed:\n" + failed[0])
            raise
        got = _drain(results, len(procs), timeout_s)
        for p in procs:
            p.join(timeout_s)
            if p.is_alive():
                p.kill()
        missing = [r for r in range(1, world) if r not in got]
        failed = [msg for ok, msg in got.values() if not ok]
        if failed or missing:
            raise RuntimeError(
                "a rank of the group failed:\n" + (failed[0] if failed else f"ranks {missing} returned nothing")
            )
        return [out0] + [got[r][1] for r in range(1, world)]


def _drain(results, n: int, timeout_s: float) -> dict:
    """Up to ``n`` (rank, ok, value) messages, waiting at most ``timeout_s``
    in all."""
    got, deadline = {}, time.monotonic() + timeout_s
    while len(got) < n:
        try:
            rank, ok, value = results.get(timeout=max(deadline - time.monotonic(), 0.01))
        except queue_mod.Empty:
            break
        got[rank] = (ok, value)
    return got
