"""The per-layer metrics that read the program's own spans
(``nvfpcc_tpu_torch/utils/trace.py``): None for the other kind of run, for
an empty store and for a program without the module; otherwise the median
over the profiled requests (the last ones in the store) of each request's
sum."""

import sys

import pytest

from benchmark.harness import Registry

# metric -> (run kind, the obs key that counts the profiled requests, span, field)
READERS = {
    "net_grad_ms.train": ("train", "stretch_epochs", "train.net_grad", "device_ms"),
    "adam_ms.train": ("train", "stretch_epochs", "train.adam", "device_ms"),
    "decoder_build_ms.decode": ("decode", "stretch_decodes", "codec.decoder", "host_ms"),
    "recon_device_ms.decode": ("decode", "stretch_decodes", "codec.recon.forward", "device_ms"),
    "points_assemble_ms.decode": ("decode", "stretch_decodes", "codec.recon.assemble", "host_ms"),
}


def read(name, obs):
    return Registry().reader(name).read(obs)


def store(span, field, values):
    """Span records by hand: per request, a few spans of ``span`` whose
    ``field`` milliseconds sum to the request's value; plus a span of
    another name and one with no request, which no reader counts."""
    from nvfpcc_tpu_torch.utils import trace

    out = []
    for request, total in values:
        for part in (0.25, 0.75):
            ms = total * part
            out.append(trace.Span(span, 0, None, request, host_ns=int(round(ms * 1e6)) if field == "host_ms" else 1,
                                  _device_ms=ms if field == "device_ms" else None))
    out.append(trace.Span("codec.other", 0, None, values[-1][0], host_ns=10**9, _device_ms=1e3))
    out.append(trace.Span(span, 0, None, None, host_ns=10**9, _device_ms=1e3))
    return out


@pytest.mark.parametrize("name", sorted(READERS))
def test_the_median_of_the_profiled_requests(monkeypatch, name):
    from nvfpcc_tpu_torch.utils import trace

    kind, count, span, field = READERS[name]
    # an earlier profile in the process (request 3), then the profiled stretch
    values = [(3, 100.0), (7, 10.0), (8, 14.0), (9, 11.0)]
    monkeypatch.setattr(trace, "spans", lambda: store(span, field, values))
    assert read(name, {"kind": kind, count: 3}) == pytest.approx(11.0)
    assert read(name, {"kind": kind, count: 2}) == pytest.approx(12.5)
    assert read(name, {"kind": kind, count: 1}) == pytest.approx(11.0)


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_where_there_is_nothing_to_read(monkeypatch, name):
    import nvfpcc_tpu_torch.utils as utils
    from nvfpcc_tpu_torch.utils import trace

    kind, count, span, field = READERS[name]
    other = "decode" if kind == "train" else "train"
    values = [(1, 5.0)]
    monkeypatch.setattr(trace, "spans", lambda: store(span, field, values))
    assert read(name, {"kind": other, "stretch_epochs": 1, "stretch_decodes": 1}) is None
    assert read(name, {"kind": kind}) is None  # a run without a profiled stretch
    monkeypatch.setattr(trace, "spans", lambda: [])
    assert read(name, {"kind": kind, count: 1}) is None
    if field == "device_ms":  # spans recorded on the CPU carry host time only
        host_only = [trace.Span(span, 0, None, 1, host_ns=10**6)]
        monkeypatch.setattr(trace, "spans", lambda: host_only)
        assert read(name, {"kind": kind, count: 1}) is None
    # a program without the module (an earlier commit)
    monkeypatch.delattr(utils, "trace")
    monkeypatch.setitem(sys.modules, "nvfpcc_tpu_torch.utils.trace", None)
    assert read(name, {"kind": kind, count: 1}) is None
