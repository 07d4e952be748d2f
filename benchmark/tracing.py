"""Spans around the program's functions, and the reading of a
``torch.profiler`` trace: device busy time, the device operations that
took most time, and the longest idle gaps by what the host was doing.

Spans are recorded from the benchmark's own files by wrapping a function
of the program for the length of a run; the program is not changed. A
device span is a pair of CUDA events read after the window; a host span
ends in a synchronisation when its function put work on the device.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Wrapped:
    """Replace ``owner.name`` by ``make(original)`` until :meth:`restore`."""

    def __init__(self, owner, name: str, make: Callable):
        self.owner, self.name = owner, name
        self.had_own = name in getattr(owner, "__dict__", {})
        self.original = getattr(owner, name)
        setattr(owner, name, make(self.original))

    def restore(self) -> None:
        if self.had_own:
            setattr(self.owner, self.name, self.original)
        else:
            delattr(self.owner, self.name)


def event_span(owner, name: str, store: list, device) -> Wrapped:
    """Each call of ``owner.name`` appends a (start, end) pair recorded on
    the current stream around it: CUDA events on a card, the host clock
    (after the call's work) elsewhere."""
    cuda = torch.device(device).type == "cuda"

    def make(fn):
        def wrapper(*args, **kwargs):
            if not cuda:
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                store.append((t0, time.perf_counter()))
                return out
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            store.append((e0, e1))
            return out
        return wrapper

    return Wrapped(owner, name, make)


def event_ms(pairs: list) -> List[float]:
    """Milliseconds of each pair of :func:`event_span`."""
    if pairs and isinstance(pairs[0][0], float):
        return [1e3 * (b - a) for a, b in pairs]
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def host_span(owner, name: str, store: list, sync: Optional[torch.device] = None) -> Wrapped:
    """Each call of ``owner.name`` appends its host seconds; with ``sync``
    the span ends after the device has finished the call's work."""

    def make(fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync is not None and sync.type == "cuda":
                torch.cuda.synchronize(sync)
            store.append(time.perf_counter() - t0)
            return out
        return wrapper

    return Wrapped(owner, name, make)


def annotated(owner, name: str, label: str) -> Wrapped:
    """Each call of ``owner.name`` runs inside a profiler annotation ``label``."""

    def make(fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    return Wrapped(owner, name, make)


# -- the profiler's events ----------------------------------------------------

def activities(device) -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _ns(e, which: str) -> int:
    if hasattr(e, f"{which}_ns"):
        return int(getattr(e, f"{which}_ns")())
    return int(getattr(e, f"{which}_us")() * 1000)


def _kind(e) -> str:
    """The event's activity: kineto's name for it where the event carries
    one, else from its device and whether it is an annotation."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    ann = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if ann else "kernel"
    return "user_annotation" if ann else "cpu_op"


def events(prof, require_device: bool = True):
    """(device intervals, host intervals) of a finished profile, each a list
    of (start_ns, end_ns, name); device intervals are kernels, copies and
    fills (not the profiler's annotations of host spans on the device's
    timeline)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        start = _ns(e, "start")
        iv = (start, start + _ns(e, "duration"), e.name())
        if kind in DEVICE_ACTIVITIES:
            dev.append(iv)
        elif kind in HOST_ACTIVITIES:
            host.append(iv)
    dev.sort()
    if require_device and not dev:
        raise RuntimeError("torch.profiler recorded no device operation")
    return dev, host


def union(intervals) -> list:
    """Merged (start, end) of intervals sorted by start."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(intervals, windows=None) -> int:
    """Length of the union of ``intervals``, within the (start, end)
    ``windows`` when given."""
    merged = union(intervals)
    if windows is None:
        return sum(e - s for s, e in merged)
    total = 0
    for ws, we in union(windows):
        total += sum(max(0, min(e, we) - max(s, ws)) for s, e in merged)
    return total


def top_ops(intervals, n: int = 10) -> list:
    """The ``n`` device operations by total seconds: [[name, seconds], ...]."""
    tot: dict = {}
    for s, e, name in intervals:
        tot[name] = tot.get(name, 0) + (e - s)
    return [[k[:120], v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(device, host, start: int, end: int, n: int = 10) -> list:
    """The ``n`` longest gaps in ``[start, end]`` when no device operation
    ran, each named by the innermost host event under its middle:
    [[name, seconds], ...]."""
    merged = union(device)
    gaps, cur = [], start
    for s, e in merged:
        if s > cur:
            gaps.append((cur, min(s, end)))
        cur = max(cur, e)
    if cur < end:
        gaps.append((cur, end))
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])[:n]
    out = []
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        under = [h for h in host if h[0] <= mid <= h[1]]
        name = min(under, key=lambda h: h[1] - h[0])[2] if under else "host (no event)"
        out.append([name[:120], (ge - gs) / 1e9])
    return out


def annotation_windows(host, label: str) -> list:
    return [(s, e) for s, e, name in host if name == label]
