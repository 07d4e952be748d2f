"""The port's spans (``nvfpcc_tpu_torch/utils/trace.py``): off without a
profiler, the decode's and the epoch's span trees under one, and their
starts on the profiler's clock.

On the CPU at toy sizes: a 3-block fixture pack, and 6 toy blocks in
batches of 2. The file imports no jax, so the cases marked ``cuda`` (a
real CUDA-graph capture, the clock check on the card) also run where jax
is not installed; there ``--noconftest`` keeps out ``tests/conftest.py``:

    python -m pytest tests/test_torch_trace.py -m cuda --noconftest -o "markers=cuda: needs a CUDA card" -p no:cacheprovider
"""

import math
import os

import numpy as np
import pytest
import torch

from nvfpcc_tpu_torch import codec
from nvfpcc_tpu_torch.codec import codec as codec_mod
from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.models import decoder as M
from nvfpcc_tpu_torch.train import graphs as G
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import trace

PACK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "packs", "pack_v3.pk")
CH, CHANNELS, CHANSTR = 2, (4, 8, 4, 4), "4,8,4,4"
N_BLOCKS, BATCH = 6, 2

DECODE_PARENTS = {
    "codec.decode": None, "codec.unpack_weights": "codec.decode", "codec.decoder": "codec.decode",
    "codec.latents": "codec.decode", "codec.latents.ctx": "codec.latents", "codec.origins": "codec.decode",
    "codec.recon": "codec.decode",
    "codec.recon.forward": "codec.recon", "codec.recon.extract": "codec.recon",
    "codec.recon.assemble": "codec.recon",
}
EPOCH_PARENTS = {
    "train.epoch": None, "train.net_steps": "train.epoch", "train.load_plan": "train.net_steps",
    "train.net_grad": "train.net_steps", "train.adam": "train.net_steps", "train.emb_update": "train.epoch",
    "train.graph_capture": "train.net_steps",
}


@pytest.fixture(autouse=True)
def one_thread_and_an_empty_store():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    trace.reset()
    yield
    trace.reset()
    torch.set_num_threads(n)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def toy_program(device, graphs=False):
    """An ``EpochProgram`` over 6 toy blocks in batches of 2 (3 net steps
    an epoch), f32, and its epoch's batch plan."""
    rng = np.random.default_rng(1)
    gt = (rng.uniform(0, 1, (N_BLOCKS, 32, 32, 32)) < 0.02).astype(np.uint8)
    dist = (rng.uniform(0, 6, gt.shape) * (1 - gt)).astype(np.float32)
    mcfg = ModelConfig(ch=CH, chanstr=CHANSTR)
    cfg = TrainConfig(batch_size=BATCH, phase_change=0, seed=5, compute_dtype="f32")
    spec = M.build_model_spec(CH, CHANNELS)
    net = TT.initial_params(spec, mcfg, device)
    emb = M.init_embeddings(N_BLOCKS, CH, device).requires_grad_(True)
    opt, emb_opt = TT.make_optimizers(cfg, net, emb)
    state = TT.TrainState(net, opt, emb, emb_opt)
    gt_d, dist_d = TT._prep_dense(gt, dist, device)
    noise = TT.NoiseSource(cfg.seed, spec, device)
    program = TT.EpochProgram(state, cfg, gt_d, dist_d, torch.ones(N_BLOCKS, device=device), float(gt.sum()),
                              noise, graphs=graphs)
    idx, mask = TT.batch_plan(N_BLOCKS, BATCH, cfg.shuffle, cfg.seed, 0)
    return program, torch.from_numpy(idx).long(), torch.from_numpy(mask)


def by_name(records):
    out = {}
    for s in records:
        out.setdefault(s.name, []).append(s)
    return out


def check_tree(records, parents):
    """Each span's parent is the one ``parents`` names, it lies within its
    parent on the host clock, and it carries its root's request."""
    for s in records:
        parent = None if s.parent is None else records[s.parent]
        assert (parent.name if parent else None) == parents[s.name], (s.name, parent)
        root = s
        while root.parent is not None:
            root = records[root.parent]
        assert s.request == root.request and s.host_ns is not None
        if parent is not None:
            slack = 50_000  # ns: the realtime start against perf_counter durations
            assert parent.start_ns <= s.start_ns + slack
            assert s.start_ns + s.host_ns <= parent.start_ns + parent.host_ns + slack


def test_spans_are_off_without_a_profiler():
    assert trace.span("x") is trace.span("y", device=True, request=3)
    codec.decode(codec.load_pack(PACK), "cpu")
    program, idx, mask = toy_program("cpu")
    program.run(0, 2, idx, mask)
    assert trace.spans() == [] and trace.dropped() == 0


@pytest.mark.parametrize("batch", [codec_mod.RECON_BATCH, 2])
def test_a_decode_gives_its_span_tree(monkeypatch, batch):
    monkeypatch.setattr(codec_mod, "RECON_BATCH", batch)
    pack = codec.load_pack(PACK)
    with profiled():
        points, info = codec.decode(pack, "cpu")
    records = trace.spans()
    names = by_name(records)
    n_batches = math.ceil(info["n_blocks"] / batch)
    assert {k: len(v) for k, v in names.items()} == {
        k: n_batches if k in ("codec.recon.forward", "codec.recon.extract") else 1 for k in DECODE_PARENTS}
    request = names["codec.decode"][0].request
    assert isinstance(request, int)
    check_tree(records, DECODE_PARENTS)
    assert all(s.device_ms() is None for s in records)  # the CPU records host time only
    # the next decode is the next request
    with profiled():
        codec.decode(pack, "cpu")
    assert list(trace.summary("codec.decoder")) == [request, request + 1]


def test_an_eager_epoch_gives_its_span_tree():
    program, idx, mask = toy_program("cpu")
    with profiled():
        program.run(4, 2, idx, mask)
    records = trace.spans()
    n = idx.shape[0]
    assert {k: len(v) for k, v in by_name(records).items()} == {
        "train.epoch": 1, "train.net_steps": 1, "train.load_plan": 1, "train.net_grad": n, "train.adam": n,
        "train.emb_update": 1}
    check_tree(records, EPOCH_PARENTS)
    assert records[0].request == 4
    grads = trace.summary("train.net_grad")
    assert list(grads) == [4] and grads[4]["count"] == n and grads[4]["host_ms"] > 0
    assert grads[4]["device_ms"] is None  # the CPU records host time only


def test_captures_are_counted_at_the_phase_start_only(monkeypatch):
    """The graphs emulated as in tests/test_torch_graph_emulation.py: each
    capture is one ``train.graph_capture`` span, and none is opened inside
    a capture."""
    opened_inside = []

    def emulated(step, mutated, generators=(), pool=None, stream=None):
        n0 = len(trace.spans())
        G.warm_up(step, mutated, generators)
        opened_inside.append(len(trace.spans()) - n0)
        return type("Replayed", (), {"replay": lambda self: step(), "pool": lambda self: None})()

    monkeypatch.setattr(TT, "capture", emulated)
    program, idx, mask = toy_program("cpu")
    program.use_graphs = True
    with profiled():
        program.run(0, 2, idx, mask)
        program.run(1, 2, idx, mask)
    captures = trace.summary("train.graph_capture")
    assert {r: v["count"] for r, v in captures.items()} == {0: 2}
    assert opened_inside == [0, 0]
    check_tree(trace.spans(), EPOCH_PARENTS)
    for epoch in (0, 1):
        assert trace.summary("train.net_grad")[epoch]["count"] == idx.shape[0]


def test_the_store_is_bounded_and_requests_pass_down(monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 3)
    with profiled():
        with trace.span("root", request=7):
            with trace.span("child"):
                with trace.span("leaf"):
                    pass
            with trace.span("child"):
                pass
        with trace.span("other"):
            pass
    records = trace.spans()
    assert [(s.name, s.parent, s.request) for s in records] == [("root", None, 7), ("child", 0, 7), ("leaf", 1, 7)]
    assert trace.dropped() == 2
    assert trace.summary("child")[7]["count"] == 1
    trace.reset()
    assert trace.spans() == [] and trace.dropped() == 0


def _annotation_starts(prof) -> dict:
    """Host-side ``record_function`` ranges of a finished profile: name ->
    sorted start_ns."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        kind = e.activity_type() if hasattr(e, "activity_type") else (
            "user_annotation" if e.device_type() == torch.autograd.DeviceType.CPU and e.is_user_annotation() else "")
        if kind == "user_annotation":
            out.setdefault(e.name(), []).append(int(e.start_ns()))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("where", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_spans_share_the_profilers_clock(where):
    """A span's start (``time.time_ns()``) lies within 1 ms of its profiler
    event's, so a trace's gaps can be named by the spans around them."""
    device = card() if where == "cuda" else torch.device("cpu")
    program, idx, mask = toy_program(device)
    pack = codec.load_pack(PACK)
    with profiled() as prof:
        codec.decode(pack, device)
        program.run(0, 2, idx, mask)
    events = _annotation_starts(prof)
    records = by_name(trace.spans())
    assert set(records) <= set(events)
    for name, spans in records.items():
        assert len(events[name]) == len(spans), name
        for s, ev in zip(sorted(spans, key=lambda s: s.start_ns), events[name]):
            assert abs(s.start_ns - ev) < 1_000_000, (name, s.start_ns - ev)


@pytest.mark.cuda
def test_a_graphed_epoch_records_nothing_while_capturing(monkeypatch):
    """On the card: no span opens and no CUDA event is recorded during a
    capture; the capture epoch counts 2 captures, a steady epoch none, and
    its device spans read device time."""
    device = card()
    during = {"capturing": False, "events": 0, "spans": 0}
    real_capture, real_record = TT.capture, torch.cuda.Event.record

    def watched_capture(*a, **kw):
        n0 = len(trace.spans())
        during["capturing"] = True
        try:
            return real_capture(*a, **kw)
        finally:
            during["capturing"] = False
            during["spans"] += len(trace.spans()) - n0

    def watched_record(self, *a, **kw):  # the capture's own stream syncs record events outside it
        during["events"] += during["capturing"] and torch.cuda.is_current_stream_capturing()
        return real_record(self, *a, **kw)

    monkeypatch.setattr(TT, "capture", watched_capture)
    monkeypatch.setattr(torch.cuda.Event, "record", watched_record)
    program, idx, mask = toy_program(device, graphs=True)
    with profiled():
        program.run(0, 2, idx, mask)
        program.run(1, 2, idx, mask)
    torch.cuda.synchronize()
    assert during == {"capturing": False, "events": 0, "spans": 0}
    assert {r: v["count"] for r, v in trace.summary("train.graph_capture").items()} == {0: 2}
    n = idx.shape[0]
    for name in ("train.net_grad", "train.adam", "train.net_steps", "train.emb_update"):
        steady = trace.summary(name)[1]
        assert steady["count"] == (n if name in ("train.net_grad", "train.adam") else 1)
        assert steady["device_ms"] is not None and steady["device_ms"] > 0, name


ENCODE_PARENTS = {
    "codec.encode.ctx": None, "codec.recon": None,
    "codec.recon.forward": "codec.recon", "codec.recon.extract": "codec.recon", "codec.recon.assemble": "codec.recon",
}


@pytest.mark.parametrize("mode", ["ctx_ar", "ctx", "channel"])
def test_the_ctx_coder_gives_its_spans_and_counts(mode):
    """A 3-block pack of a zero-residual model: in the ctx modes the encode's
    ``codec.encode.ctx`` (a root, before the encode's ``codec.recon``) and
    the decode's ``codec.latents.ctx`` (under ``codec.latents``) count the
    mode, the coding steps (8, or 8 * ch in ctx_ar), the symbols and the
    tables the decode built; a channel pack has neither."""
    from benchmark.generators import synthetic_origins
    from nvfpcc_tpu_torch.config import CodecConfig
    from nvfpcc_tpu_torch.utils.params import params_to_numpy

    mcfg = ModelConfig(ch=CH, chanstr=CHANSTR, entropy_mode=mode, ctx_hidden=8, ctx_tail=4 if mode == "ctx_ar" else 0)
    params = params_to_numpy(M.init_params(codec.model_spec(mcfg)))
    emb = np.random.default_rng(2).normal(0, 3, (3, 2, 2, 2, CH)).astype(np.float32)
    origins = synthetic_origins(3, 10, 5, 1)
    ccfg = CodecConfig(thh_encode=0.5, qp=16, depth=10, level=5)
    with profiled():
        res = codec.encode(params, emb, origins, mcfg, ccfg, 100, "cpu")
    records = trace.spans()
    check_tree(records, ENCODE_PARENTS)
    assert records[0].name == ("codec.recon" if mode == "channel" else "codec.encode.ctx")
    assert all(s.request is None for s in records)
    trace.reset()
    with profiled():
        codec.decode(res.pack, "cpu")
    decode_records = trace.spans()
    check_tree(decode_records, DECODE_PARENTS)
    enc, dec = by_name(records).get("codec.encode.ctx", []), by_name(decode_records).get("codec.latents.ctx", [])
    if mode == "channel":
        assert enc == [] and dec == []
        return
    counts = {"mode": mode, "steps": 8 * CH if mode == "ctx_ar" else 8, "symbols": 3 * 8 * CH}
    (tables,) = {s.counts["tables"] for s in enc + dec}  # the round trip's and the decode's
    assert 1 <= tables <= counts["symbols"]
    assert [s.counts for s in enc] == [{**counts, "clamped": 0, "tables": tables}]
    assert [s.counts for s in dec] == [{**counts, "tables": tables}]


def test_the_ctx_fit_records_a_span_a_phase_and_nothing_while_off(monkeypatch):
    """``ctx_fit.phase``: one span a phase with its q and steps under a
    profiler; without one, no span object is made and the store stays
    empty."""
    from nvfpcc_tpu_torch.train.ctx_fit import fit_ctx_predictor

    spec = M.build_model_spec(CH, CHANNELS, entropy_mode="ctx_ar", ctx_hidden=8, ctx_tail=4)
    lat = np.random.default_rng(3).integers(-4, 5, (4, 2, 2, 2, CH))
    made = []
    real_on = trace._On

    def counted(*a, **kw):
        made.append(a[0])
        return real_on(*a, **kw)

    monkeypatch.setattr(trace, "_On", counted)
    kw = dict(steps=250, finetune_steps=250, early_stop=0.0, log=lambda s: None)
    fit_ctx_predictor(spec, lat, "cpu", **kw)
    assert made == [] and trace.spans() == []
    with profiled():
        fit_ctx_predictor(spec, lat, "cpu", **kw)
    phases = [s for s in trace.spans() if s.name == "ctx_fit.phase"]
    assert [s.counts for s in phases] == [{"q": 0, "steps": 250}, {"q": 2, "steps": 250}]
    assert all(s.parent is None and s.host_ns > 0 and s.device_ms() is None for s in phases)
