"""One client in a closed loop over a set of frames: the decode cells' window.

Each request is timed on its own by the host clock: from before the
program loads the frame's pack to after the device has finished the
decode. Between two requests, outside the timed intervals, the client
compares the points it got back with the arrays it keeps of that frame
(``np.array_equal``), keeps them only where none is equal, and drops
them. So the window holds at most one array per distinct answer however
many decodes it makes, and the memory the process holds does not grow
with the window's length; every decode is still checked, after the
window, by the gap of its key's array (:meth:`Window.gaps`). Python's
garbage collector is off between requests and on inside them, so a
collection that the program's garbage calls for falls inside a timed
request and never in the client's gap.

The window ends once the requests' times add up to ``seconds``. Around
it the log gives the process's page faults, CPU seconds, resident size,
threads and garbage collections, and the card's clocks, so a run that
reads slow can be told apart from a card that ran slow.
"""

from __future__ import annotations

import gc
import os
import resource
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


@dataclass
class Window:
    """What one closed-loop window did."""

    request_s: list = field(default_factory=list)  # each request's seconds, in order
    keys: list = field(default_factory=list)  # each decode's (frame, index of its answer in kept[frame])
    kept: dict = field(default_factory=dict)  # frame -> the distinct answers it gave, in order
    wall_s: float = 0.0  # the window from its first request, the client's comparisons included
    client_s: float = 0.0  # the client's comparisons between requests

    @property
    def timed_s(self) -> float:
        return sum(self.request_s)

    def gaps(self, gap_of: Callable[[int, np.ndarray], float]) -> list:
        """Each decode's ``gap_of(frame, points)``, worked out once a key."""
        by_key = {(i, j): gap_of(i, points) for i, answers in self.kept.items() for j, points in enumerate(answers)}
        return [by_key[key] for key in self.keys]


def process_stats() -> dict:
    """This process's page faults, CPU seconds, resident bytes, Python
    threads and garbage collections by generation."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    try:
        with open("/proc/self/statm") as f:
            rss = int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except OSError:
        rss = None
    return {"minflt": ru.ru_minflt, "majflt": ru.ru_majflt, "cpu_s": ru.ru_utime + ru.ru_stime, "rss_bytes": rss, "threads": threading.active_count(),
            "collections": [g["collections"] for g in gc.get_stats()]}


def card_clocks(dev) -> str:
    """The card's clocks, power draw, temperature and throttle reasons."""
    if torch.device(dev).type != "cuda":
        return "no card"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def run(request: Callable[[int], np.ndarray], n_frames: int, seconds: float, dev, log=print) -> Window:
    """Call ``request(i)`` for frames ``i`` = 0, 1, ... in turn until the
    requests' times add up to ``seconds``. ``request`` returns the points
    of one decode; the device is synchronised inside each timed interval,
    so no request's work spills into the next."""
    cuda = torch.device(dev).type == "cuda"
    win = Window()
    clocks, before = card_clocks(dev), process_stats()
    gc_was_on = gc.isenabled()
    t_epoch, t_start = time.time(), time.perf_counter()
    try:
        while win.timed_s < seconds:
            i = len(win.keys) % n_frames
            gc.enable()
            t0 = time.perf_counter()
            points = request(i)
            if cuda:
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
            gc.disable()
            win.request_s.append(t1 - t0)
            answers = win.kept.setdefault(i, [])
            j = next((j for j, kept in enumerate(answers) if np.array_equal(kept, points)), len(answers))
            if j == len(answers):
                answers.append(points)
            win.keys.append((i, j))
            del points
            win.client_s += time.perf_counter() - t1
    finally:
        (gc.enable if gc_was_on else gc.disable)()
    win.wall_s = time.perf_counter() - t_start
    after = process_stats()
    if after["threads"] != before["threads"]:
        raise RuntimeError(f"the window started with {before['threads']} threads and ended with {after['threads']}")
    n = len(win.keys)
    log(f"[window] from {t_epoch:.3f} (host epoch seconds): {n} decodes, timed {win.timed_s:.4f} s, "
        f"wall {win.wall_s:.4f} s, client comparing {win.client_s:.4f} s, "
        f"{sum(map(len, win.kept.values()))} distinct answers kept; "
        f"page faults a decode: minor {(after['minflt'] - before['minflt']) / n:.0f}, major "
        f"{(after['majflt'] - before['majflt']) / n:.2f}; resident bytes {before['rss_bytes']} -> "
        f"{after['rss_bytes']}; threads {after['threads']}; CPU seconds before {before['cpu_s']:.2f}, in it "
        f"{after['cpu_s'] - before['cpu_s']:.2f}; garbage collections by generation "
        f"{[b - a for a, b in zip(before['collections'], after['collections'])]}; "
        f"card before [{clocks}] after [{card_clocks(dev)}]")
    log(f"[window] request seconds {[round(s, 4) for s in win.request_s]}")
    return win
