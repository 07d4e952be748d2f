"""Spans of the program's stages, kept in memory, on the profiler's clock.

Spans are on exactly while a ``torch.profiler`` records: ``train
--profile``'s epochs, or any profiler an operator runs around the
program. On, a span opens a ``torch.profiler.record_function`` range of
its name, so it shows in the profiler's trace, and keeps a record here.
Off, :func:`span` reads one flag and returns a shared no-op context.

A record (:class:`Span`) holds the span's name; its start in
``time.time_ns()``, the clock the profiler stamps its events with (not
``time.perf_counter``'s), so a span lies on the trace's timeline; its host
duration from ``time.perf_counter_ns()`` (the realtime clock may step);
the index of its parent, the span open around it in the same thread; and
its request, set on a root span (a decode's number, an epoch) and
inherited by every span under it. A device span also records a pair of
CUDA events on the current stream around its work, read only when asked
(:meth:`Span.device_ms`). No event is recorded while the stream captures a
CUDA graph, and no span sits inside a captured step.

The store keeps at most ``MAX_SPANS`` records and counts those it turned
away (:func:`dropped`).

Spans of the program, by path:

- ``codec.load_pack``;
- ``codec.decode`` (request: the process's decode count), over
  ``codec.unpack_weights``, ``codec.decoder`` (the seeded decoder rebuilt
  and copied to the device), ``codec.latents``, ``codec.origins`` and
  ``codec.recon``; in the ctx modes ``codec.latents`` is over
  ``codec.latents.ctx`` (the host ctx coder's decode), which counts the
  mode, its coding steps (8, or 8 * ch in ``ctx_ar``), its symbols and
  the distinct tables they used;
- ``codec.encode.ctx`` (no request; in an encode in the ctx modes): the
  ctx coder's encode and its round-trip decode, counted as
  ``codec.latents.ctx`` with the symbols clamped to the alphabet;
- ``codec.recon`` (also in ``encode``), over one ``codec.recon.forward``
  (device: the decoder's forward of a batch of latents already on the
  device) and one ``codec.recon.extract`` (the batch's threshold into the
  occupancy mask) per batch; then the mask's ``torch.nonzero``, the
  host's one wait for the batches, and ``codec.recon.assemble`` (the
  block origins added, the points copied to the host);
- ``train.epoch`` (request: the epoch), over ``train.net_steps`` (device)
  and ``train.emb_update`` (device); ``train.net_steps`` over
  ``train.load_plan``, ``train.graph_capture`` (one per CUDA graph
  captured: a steady epoch has none) and, per batch, ``train.net_grad``
  (device: the gradient's graph replay or eager run) and ``train.adam``
  (device: the learning rate set and the Adam step). A block-DP epoch has
  ``train.epoch`` alone;
- ``ctx_fit.phase`` (device), one per phase of the post-hoc ctx predictor
  fit (``train/ctx_fit.py``), over the phase's capture and its chunks of
  steps; it counts its ``q`` and the steps it took.

A span's counts (:func:`count`) are set on its record while it is open.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_SPANS = 1_000_000


@dataclass
class Span:
    name: str
    start_ns: int  # time.time_ns(): the profiler's clock
    parent: Optional[int]  # index of the enclosing span in the store
    request: Optional[int]
    host_ns: Optional[int] = None  # None while the span is open
    events: Optional[tuple] = None  # (start, end) CUDA events, until read
    _device_ms: Optional[float] = None
    counts: Optional[dict] = None  # what the span's work counted (:func:`count`)

    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's CUDA events (waiting for the
        end event), or None for a span that recorded none."""
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self.events = None
        return self._device_ms


class _Store:
    def __init__(self):
        self.records: List[Span] = []
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_STORE = _Store()


class _Off:
    """The shared context of a span while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "device", "request", "index", "range", "t0", "start_event", "record")

    def __init__(self, name: str, device: bool, request: Optional[int]):
        self.name, self.device, self.request = name, device, request

    def __enter__(self):
        stack = _STORE.stack()
        top = stack[-1] if stack else None
        if self.request is None and top is not None:
            self.request = top.request
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.record = Span(self.name, time.time_ns(), None if top is None else top.index, self.request)
        with _STORE.lock:
            if len(_STORE.records) < MAX_SPANS:
                self.index = len(_STORE.records)
                _STORE.records.append(self.record)
            else:
                self.index = None
                _STORE.dropped += 1
        stack.append(self)
        self.start_event = None
        if self.device and torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing():
            self.start_event = torch.cuda.Event(enable_timing=True)
            self.start_event.record()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        if self.start_event is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.record.events = (self.start_event, end)
        self.record.host_ns = time.perf_counter_ns() - self.t0
        _STORE.stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, device: bool = False, request: Optional[int] = None):
    """A context that records the span ``name`` while a profiler records
    (module docstring). ``device`` adds CUDA events around the span's work;
    ``request`` sets the request of a root span (its spans inherit it)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, device, request)


def count(**values) -> None:
    """Set ``values`` in the counts of the innermost span open in this
    thread: numbers the span's work counted (steps, symbols) and the label
    of what it counted (a mode). Nothing while spans are off."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _STORE.stack()
    if stack:
        record = stack[-1].record
        record.counts = {**(record.counts or {}), **values}


def spans() -> List[Span]:
    """The records, in the order the spans opened."""
    with _STORE.lock:
        return list(_STORE.records)


def dropped() -> int:
    """Spans turned away since the store filled."""
    return _STORE.dropped


def summary(name: str) -> Dict[Optional[int], dict]:
    """Per request (in the order each first appears), the closed spans
    ``name``: ``host_ms`` summed, ``device_ms`` summed (None unless every
    one recorded CUDA events) and ``count``."""
    out: Dict[Optional[int], dict] = {}
    for s in spans():
        if s.name != name or s.host_ns is None:
            continue
        agg = out.setdefault(s.request, {"host_ms": 0.0, "device_ms": 0.0, "count": 0})
        ms = s.device_ms()
        agg["host_ms"] += s.host_ns / 1e6
        agg["device_ms"] = None if ms is None or agg["device_ms"] is None else agg["device_ms"] + ms
        agg["count"] += 1
    return out


def reset() -> None:
    """Empty the store (between runs: not while a span is open)."""
    with _STORE.lock:
        _STORE.records.clear()
        _STORE.dropped = 0
