"""The trace arithmetic on intervals written by hand."""

from benchmark import tracing


def test_union_and_busy():
    iv = [(0, 10, "a"), (5, 12, "b"), (20, 25, "a"), (30, 31, "c")]
    assert tracing.union(iv) == [[0, 12], [20, 25], [30, 31]]
    assert tracing.busy_ns(iv) == 18
    assert tracing.busy_ns(iv, [(8, 22), (30, 40)]) == 4 + 2 + 1


def test_top_ops_and_gaps():
    dev = [(0, 10, "a"), (5, 12, "b"), (20, 25, "a"), (30, 31, "c")]
    assert tracing.top_ops(dev, 2) == [["a", 15e-9], ["b", 7e-9]]
    host = [(0, 40, "step"), (13, 19, "cudaGraphLaunch"), (26, 29, "aten::copy_")]
    gaps = tracing.idle_gaps(dev, host, 0, 40)
    assert gaps == [["step", 9e-9], ["cudaGraphLaunch", 8e-9], ["aten::copy_", 5e-9]]
