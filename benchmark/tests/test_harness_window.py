"""The decode cells' closed-loop window (``closed_loop.run``): it keeps one
array per distinct answer and drops the rest, times each request apart
from the client's comparisons, keeps Python's garbage collections out of
the client's gaps, and still checks every decode: a fault in one
later decode of a frame fails the run, one decode for each. Run through
both decode drivers on the CPU at a small size."""

import copy
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from benchmark import closed_loop, counters
from benchmark.harness import Registry
from benchmark.run import execute

INFO = {"platform": "cpu", "kind": "cpu", "count": 1, "card": "cpu"}
N_BLOCKS = 48
CELLS = ("decode.flagship_vox10", "decode.ctx_vox11")


def run_small(name, seconds, trace=False, n_blocks=N_BLOCKS, seed=2**33 + 29):
    """The cell at ``n_blocks`` blocks (its share of occupied voxels kept);
    returns its result line and its configuration."""
    reg = Registry()
    cell = reg.cell(name)
    cfg = copy.deepcopy(reg.config(cell["config"]))
    share = cfg["n_points"] / (cfg["n_blocks"] * 32**3)
    cfg["n_blocks"], cfg["n_points"] = n_blocks, round(n_blocks * 32**3 * share)
    rc, line = execute(reg, cell, seed, seconds, trace, torch.device("cpu"), config=cfg, info=INFO)
    assert rc == 0
    return line, cfg


@pytest.fixture(autouse=True)
def few_threads_and_short_fits(short_ctx_fits):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def windows(monkeypatch):
    """Each window ``closed_loop.run`` opens, and whether one is open."""
    seen, state = [], {"open": False}
    run = closed_loop.run

    def watched(*a, **kw):
        state["open"] = True
        try:
            seen.append(run(*a, **kw))
            return seen[-1]
        finally:
            state["open"] = False

    monkeypatch.setattr(closed_loop, "run", watched)
    return seen, state


@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_a_later_decode_of_a_frame_is_not_correct(monkeypatch, windows, name):
    from nvfpcc_tpu_torch import codec

    _seen, state = windows
    load_pack, decode = codec.load_pack, codec.decode
    loaded, decodes, moved = [], {}, []

    def load(path):
        loaded.append(path)
        return load_pack(path)

    def decode_moved(pack, dev):
        points, info = decode(pack, dev)
        if state["open"]:
            path = loaded[-1]
            decodes[path] = decodes.get(path, 0) + 1
            if path == next(iter(decodes)) and decodes[path] > 1:  # the first frame, after its first decode
                points[0, 2] += 1 if points[0, 2] % 32 < 31 else -1
                moved.append(path)
        return points, info

    monkeypatch.setattr(codec, "load_pack", load)
    monkeypatch.setattr(codec, "decode", decode_moved)
    line, _cfg = run_small(name, seconds=2.5, n_blocks=16)  # several decodes a frame
    assert moved, "the window made no later decode of its first frame"
    assert not line["correct"] and line["failed"] == len(moved) < line["attempted"], line


@pytest.mark.parametrize("name", CELLS)
def test_decode_mfu_reads_the_timed_sum(monkeypatch, windows, name):
    seen, state = windows
    array_equal, compared = np.array_equal, []

    def slow_array_equal(a, b):  # a slow client, outside the timed intervals
        if state["open"]:
            compared.append(1)
            time.sleep(0.2)
        return array_equal(a, b)

    monkeypatch.setattr(closed_loop.np, "array_equal", slow_array_equal)
    traced, cfg = run_small(name, seconds=1.5, trace=True)  # a frame decoded more than once
    (win,) = seen
    n, timed = len(win.keys), win.timed_s
    assert traced["correct"] and traced["attempted"] == n and compared
    assert win.wall_s >= timed + 0.2 * len(compared) and win.client_s >= 0.2 * len(compared)
    flops = counters.decode_work({**cfg, "entropy_mode": "channel"}, N_BLOCKS, 1)[0]
    expect = 100.0 * flops * n / timed / counters.PEAK_FLOPS["f32"]
    assert traced["metrics"]["decode_mfu"]["value"] == pytest.approx(expect, rel=1e-12)
    line, _cfg = run_small(name, seconds=0.5)
    win = seen[-1]
    assert line["metrics"]["decode_ms"]["value"] == pytest.approx(win.timed_s / len(win.keys) * 1e3, rel=1e-12)


def test_the_window_keeps_one_array_per_distinct_answer():
    """Frame 0 answers alike every time, frame 1 in turn two ways: the
    window keeps three arrays, frees every other, and works each gap out
    once a key."""
    calls, alive = [0, 0], []

    def request(i):
        calls[i] += 1
        time.sleep(0.001)
        points = np.full((1000, 3), i + 10 * (calls[i] % 2 if i else 0), np.int64)
        alive.append(weakref.ref(points))
        return points

    win = closed_loop.run(request, 2, 0.05, "cpu", log=lambda s: None)
    n = len(win.keys)
    assert n == len(win.request_s) == sum(calls) and n >= 6
    assert {i: len(answers) for i, answers in win.kept.items()} == {0: 1, 1: 2} and len(set(win.keys)) == 3
    assert sum(r() is not None for r in alive) == 3
    assert win.timed_s >= 0.05 and win.wall_s >= win.timed_s
    asked = []
    gaps = win.gaps(lambda i, points: asked.append(i) or float(points[0, 0]))
    assert sorted(asked) == [0, 1, 1]
    expect, count = [], [0, 0]
    for j in range(n):
        count[j % 2] += 1
        expect.append(float(j % 2 + 10 * (count[1] % 2 if j % 2 else 0)))
    assert gaps == expect


def test_a_thread_left_running_by_the_window_is_an_error():
    stop = threading.Event()
    started = []

    def request(i):
        if not started:
            started.append(threading.Thread(target=stop.wait, daemon=True))
            started[0].start()
        return np.zeros((4, 3), np.int64)

    try:
        with pytest.raises(RuntimeError, match="threads"):
            closed_loop.run(request, 1, 0.001, "cpu", log=lambda s: None)
    finally:
        stop.set()
        started[0].join(timeout=10)
    assert not started[0].is_alive()


def test_garbage_collections_fall_inside_the_timed_requests(monkeypatch):
    """Requests that leave cyclic garbage and a client whose comparisons
    allocate: every collection the window makes runs inside a request,
    none in the client's gap, and the collector is on again after it."""
    import gc

    inside, where = [], {"in": False}
    array_equal = np.array_equal

    def watch(phase, info):
        if phase == "start":
            inside.append(where["in"])

    def request(i):
        where["in"] = True
        for _ in range(2000):  # cyclic garbage, enough for a few generation-0 collections
            a = []
            a.append(a)
        where["in"] = False
        return np.zeros((4, 3), np.int64)

    def allocating_array_equal(a, b):  # more than a generation-0 threshold of new containers
        held = [[] for _ in range(2 * gc.get_threshold()[0])]
        return array_equal(a, b) and len(held) > 0

    monkeypatch.setattr(closed_loop.np, "array_equal", allocating_array_equal)
    gc.callbacks.append(watch)
    try:
        win = closed_loop.run(request, 2, 0.05, "cpu", log=lambda s: None)
    finally:
        gc.callbacks.remove(watch)
    assert len(win.keys) > 2 and inside and all(inside) and gc.isenabled()
