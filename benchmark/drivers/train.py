"""The training window: steady epochs of the per-cloud fit.

Set-up builds one training state on the device (the program's
``EpochProgram`` over grids made from the seed, with CUDA graphs on a
card) and runs its first epoch through ``train.loop.run_epoch``, the
window's own call: that epoch captures the graphs, and the benchmark reads
what the check needs from it (the first net steps' losses from the
epoch's metric rows, the net Adam's first moment after one step, the
parameters after the checked steps, the net parameters the embedding
update starts from, the embedding Adam's first moment). On a card, steady
epochs then run for ``WARM_SECONDS`` (the first epochs after set-up ran
3.8-4.6% slower in some runs on an H100 at full clocks; the warm-up
shortens that slow mode and does not always end it). The window runs chunks of ``chunk_epochs`` epochs, each
ending in one fetch of its metric rows, until ``--seconds`` have passed,
finishing the chunk it is in. ``train_epoch_ms`` is the window's wall time
over its epochs.

With ``--trace 1`` the window also records CUDA events around each
epoch's net steps and embedding update, and after it ``TRACE_EPOCHS``
more epochs run under ``torch.profiler``.

After the window and the peak's reading, one more epoch runs through the
window's own call on the same program with :class:`EpochRecorder` on it,
which keeps the state before each net step and around the embedding
update. Then, with the program's state freed, the reference follows the
first epoch's first net steps from the start, works out that epoch's
embedding gradient from the net parameters the program's update started
from, and follows the recorded epoch step by step from the program's own
state before each step (``train_ref.epoch_steps``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark import counters, generators, tracing
from benchmark.harness import Outcome
from benchmark.reference import compare
from benchmark.reference import train_ref

ADAM_B1 = 0.9
Q = 2  # the q=2 phase: the fit's steady state, 401 of its 501 epochs
CHECK_STEPS = 3  # net steps of the first epoch the reference follows
TRACE_EPOCHS = 1  # epochs under the profiler after the window
WARM_SECONDS = 20.0  # steady epochs in set-up on a card (10 s left 1 of 2 vox10 runs slow)


def _program(cfg: dict, gt, dist, seed: int, device, graphs: bool):
    """(program pieces) of one training state, as ``train`` builds it."""
    from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
    from nvfpcc_tpu_torch.device import set_train_numerics
    from nvfpcc_tpu_torch.models import decoder as M
    from nvfpcc_tpu_torch.train import loop as T

    t = cfg["train"]
    mcfg = ModelConfig(ch=cfg["ch"], chanstr=cfg["chanstr"], seed_tag=cfg["seed_tag"],
                       entropy_mode=cfg["entropy_mode"], ctx_hidden=cfg["ctx_hidden"], ctx_tail=cfg["ctx_tail"])
    tcfg = TrainConfig(lmbda=t["lmbda"], w1=t["w1"], w2=t["w2"], wemb=t["wemb"], lr=t["lr"],
                       batch_size=t["batch_size"], focal_alpha=t["focal_alpha"], ms_alpha=t["ms_alpha"],
                       beta=t["beta"], shuffle=t["shuffle"], compute_dtype=t["compute_dtype"],
                       emb_chunks=t["emb_chunks"], milestones=tuple(t["milestones"]), lr_decay=t["lr_decay"],
                       phase_change=0, eval_every=0)
    set_train_numerics()
    spec = M.build_model_spec(mcfg.ch, mcfg.channels, mcfg.seed_tag, mcfg.entropy_mode,
                              ctx_hidden=mcfg.ctx_hidden, ctx_tail=mcfg.ctx_tail)
    n = int(gt.shape[0])
    net = T.initial_params(spec, mcfg, device)
    emb = M.init_embeddings(n, mcfg.ch, device).requires_grad_(True)
    opt, emb_opt = T.make_optimizers(tcfg, net, emb)
    state = T.TrainState(net, opt, emb, emb_opt)
    gt_d, dist_d = T._prep_dense(gt, dist, device)
    n_total_pts = float(gt.sum())
    valid = torch.ones(n, device=device)
    noise = T.NoiseSource(seed, spec, device)
    idx, mask = T.batch_plan(n, tcfg.batch_size, tcfg.shuffle, tcfg.seed, 0)
    chunks = T.resolve_emb_chunks(tcfg.emb_chunks, n)
    program = T.EpochProgram(state, tcfg, gt_d, dist_d, valid, n_total_pts, noise, chunks, graphs=graphs)
    args = (state, tcfg, gt_d, dist_d, torch.from_numpy(idx).long(), torch.from_numpy(mask), valid, n_total_pts)
    return T, program, state, args, noise, chunks


def _named(net) -> dict:
    return {k.replace(".", "/"): p for k, p in net.named_parameters()}


def first_moment(opt, p):
    """The gradient an Adam got at its first step, from its first moment
    (zeros when it holds none: it took no step)."""
    st = opt.state.get(p, {})
    if "exp_avg" not in st:
        return torch.zeros_like(p.detach())
    return st["exp_avg"].detach().clone() / (1 - ADAM_B1)


class FirstEpochReader:
    """Reads, during the first epoch, what the check compares: wraps the
    net Adam's ``step`` and the program's ``emb_update`` for that epoch."""

    def __init__(self, program, state, steps: int):
        self.steps, self.calls = steps, 0
        self.params = _named(state.net)
        self.theta0 = {k: p.detach().clone() for k, p in self.params.items()}
        self.grad1 = self.theta_k = self.theta_emb = self.emb_grad = None
        self.wraps = [
            tracing.Wrapped(state.opt, "step", self._step),
            tracing.Wrapped(program, "emb_update", self._emb_update),
        ]
        self.state = state

    def _step(self, fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            self.calls += 1
            if self.calls == 1:
                self.grad1 = {k: first_moment(self.state.opt, p) for k, p in self.params.items()}
            if self.calls == self.steps:
                self.theta_k = {k: p.detach().clone() for k, p in self.params.items()}
            return out
        return wrapper

    def _emb_update(self, fn):
        def wrapper(*a, **kw):
            self.theta_emb = {k: p.detach().clone() for k, p in self.params.items()}
            out = fn(*a, **kw)
            self.emb_grad = first_moment(self.state.emb_opt, self.state.emb)
            return out
        return wrapper

    def restore(self) -> None:
        for w in self.wraps:
            w.restore()

    def readings(self, losses: list) -> dict:
        """The program's side of the check. What the epoch never reached
        (no Adam step, no update) reads as a state left unchanged."""
        zeros = {k: torch.zeros_like(v) for k, v in self.theta0.items()}
        theta_k = self.theta_k if self.theta_k is not None else self.theta0
        return {
            "losses": losses,
            "grad1": self.grad1 if self.grad1 is not None else zeros,
            "change": {k: theta_k[k] - self.theta0[k] for k in self.theta0},
            "emb_grad": self.emb_grad if self.emb_grad is not None else torch.zeros_like(self.state.emb.detach()),
        }


def _moments(opt, p) -> tuple:
    """(m, v, earlier steps) of ``p`` in the Adam ``opt`` (zeros before
    its first step)."""
    st = opt.state.get(p, {})
    if "exp_avg" not in st:
        z = torch.zeros_like(p.detach())
        return z, z, 0.0
    return st["exp_avg"].detach().clone(), st["exp_avg_sq"].detach().clone(), float(st["step"])


class EpochRecorder:
    """Keeps, through one epoch, the state before each net Adam step (the
    parameters, their gradient as Adam gets it, its moments and count) and
    around the embedding update; :meth:`sides` hands the reference its
    inputs and the program's side of the check."""

    def __init__(self, program, state):
        self.state, self.params = state, _named(state.net)
        self.steps, self.emb = [], None
        self.t0 = self._count()
        self.wraps = [
            tracing.Wrapped(state.opt, "step", self._step),
            tracing.Wrapped(program, "emb_update", self._emb_update),
        ]

    def _count(self) -> float:
        return _moments(self.state.opt, next(iter(self.params.values())))[2]

    def _step(self, fn):
        def wrapper(*a, **kw):
            snap = {"theta": {}, "grad": {}, "m": {}, "v": {}, "t": self._count()}
            for k, p in self.params.items():
                snap["theta"][k] = p.detach().clone()
                snap["grad"][k] = torch.zeros_like(p) if p.grad is None else p.grad.detach().clone()
                snap["m"][k], snap["v"][k], _ = _moments(self.state.opt, p)
            self.steps.append(snap)
            return fn(*a, **kw)
        return wrapper

    def _emb_update(self, fn):
        def wrapper(*a, **kw):
            e = self.state.emb
            before = e.detach().clone()
            m, v, t = _moments(self.state.emb_opt, e)
            out = fn(*a, **kw)
            self.emb = {"emb": before, "emb_m": m, "emb_v": v, "emb_t": t,
                        "grad": e.grad.detach().clone(), "change": e.detach() - before}
            return out
        return wrapper

    def sides(self, losses: list) -> tuple:
        """(reference inputs, program side) of the recorded epoch with the
        losses of its metric rows; restores what it wrapped."""
        for w in self.wraps:
            w.restore()
        theta_end = {k: p.detach().clone() for k, p in self.params.items()}
        thetas = [s["theta"] for s in self.steps] + [theta_end]
        emb = self.emb or {"emb": self.state.emb.detach().clone(), "emb_m": None, "emb_v": None, "emb_t": 0.0,
                           "grad": None, "change": None}
        rec = {"steps": [{k: s[k] for k in ("theta", "m", "v", "t")} for s in self.steps], "theta_end": theta_end,
               **{k: emb[k] for k in ("emb", "emb_m", "emb_v", "emb_t")}}
        if rec["emb_m"] is None:
            rec["emb_m"] = rec["emb_v"] = torch.zeros_like(rec["emb"])
        prog = {"losses": losses[:len(self.steps)], "grads": [s["grad"] for s in self.steps],
                "changes": [{k: b[k] - a[k] for k in a} for a, b in zip(thetas, thetas[1:])],
                "steps": len(self.steps), "adam_steps": self._count() - self.t0,
                "emb_grad": emb["grad"], "emb_change": emb["change"]}
        return rec, prog


def record_epoch(T, program, state, args, noise, chunks, epoch: int) -> tuple:
    """Run epoch ``epoch`` through ``run_epoch`` on ``program`` under an
    :class:`EpochRecorder`; returns its (reference inputs, program side)."""
    recorder = EpochRecorder(program, state)
    rows = T.run_epoch(*args, Q, noise, epoch, chunks, program=program)
    return recorder.sides(rows[:, T.METRIC_KEYS.index("loss")].tolist())


def run(ctx) -> Outcome:
    cfg, traffic, dev = ctx.config, ctx.traffic, torch.device(ctx.device)
    cuda = dev.type == "cuda"
    chunk, n = int(traffic["chunk_epochs"]), int(cfg["n_blocks"])
    if CHECK_STEPS > -(-n // cfg["train"]["batch_size"]):
        raise ValueError(f"the check follows {CHECK_STEPS} net steps; {n} blocks make fewer batches")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)

    # -- set-up: grids from the seed, the training state, the first epoch
    gt, dist = generators.training_grids(ctx.seed, n, dev)
    T, program, state, args, noise, chunks = _program(cfg, gt, dist, ctx.seed, dev, graphs=cuda)
    reader = FirstEpochReader(program, state, CHECK_STEPS)
    rows0 = T.run_epoch(*args, Q, noise, 0, chunks, program=program).cpu().numpy()
    reader.restore()
    prog_losses = [float(x) for x in rows0[:CHECK_STEPS, T.METRIC_KEYS.index("loss")]]
    epoch = 1

    def run_chunk(k: int) -> bool:
        nonlocal epoch
        rows = [T.run_epoch(*args, Q, noise, epoch + j, chunks, program=program) for j in range(k)]
        epoch += k
        return bool(np.isfinite(torch.stack(rows).cpu().numpy()).all())  # the chunk's one fetch

    # steady epochs before the window, until WARM_SECONDS of them have run
    t_warm = time.perf_counter()
    while time.perf_counter() - t_warm < (WARM_SECONDS if cuda else 0.0):
        run_chunk(1)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - ctx.t_start

    # -- the window
    net_ev, emb_ev = [], []
    spans = [tracing.event_span(program, "net_steps", net_ev, dev),
             tracing.event_span(program, "emb_update", emb_ev, dev)] if ctx.trace else []
    attempted = failed = 0
    t0, t0_wall = time.perf_counter(), time.time()
    marks = []
    while True:
        ok = run_chunk(chunk)
        attempted += chunk
        failed += 0 if ok else chunk
        window_s = time.perf_counter() - t0
        marks.append(window_s)
        if window_s >= ctx.seconds:
            break
    ctx.log(f"[train] window from {t0_wall:.3f} (host epoch seconds), chunk seconds "
            f"{[round(b - a, 4) for a, b in zip([0.0] + marks, marks)]}")
    for s in spans:
        s.restore()
    dtype = cfg["train"]["compute_dtype"]
    args_batches = int(args[4].shape[0])
    flops, bytes_ = counters.train_epoch_work(cfg, n, args_batches, chunks)
    obs = {"kind": "train", "window_s": window_s, "epochs": attempted, "flops_per_epoch": flops,
           "least_s_per_epoch": counters.least_seconds(flops, bytes_, dtype), "peak_flops": counters.PEAK_FLOPS[dtype]}
    busy_s = stretch_s = breakdown = None
    if ctx.trace:
        obs.update(net_steps_ms=tracing.event_ms(net_ev), emb_update_ms=tracing.event_ms(emb_ev))
        with torch.profiler.profile(activities=tracing.activities(dev)) as prof:
            with torch.profiler.record_function("bench.stretch"):
                run_chunk(TRACE_EPOCHS)
        devs, host = tracing.events(prof, cuda)
        win = tracing.annotation_windows(host, "bench.stretch")
        start, end = win[0] if win else (devs[0][0], devs[-1][1])
        stretch_s = (end - start) / 1e9
        busy_s = tracing.busy_ns(devs, [(start, end)]) / 1e9
        obs.update(stretch_s=stretch_s, stretch_busy_s=busy_s, stretch_epochs=TRACE_EPOCHS)
        breakdown = {"device_ops": tracing.top_ops(devs), "idle_gaps": tracing.idle_gaps(devs, host, start, end)}
        del prof
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    # -- the check: one more epoch recorded, the program's state freed, then the reference
    rec, epoch_side = record_epoch(T, program, state, args, noise, chunks, epoch)
    program_side = reader.readings(prog_losses)
    theta_emb = reader.theta_emb if reader.theta_emb is not None else reader.theta0
    del program, state, args, reader, spans
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = train_ref.follow_steps(cfg, gt, dist, ctx.seed, CHECK_STEPS, dtype)
    ref["emb_grad"] = train_ref.full_set_emb_grad(cfg, theta_emb, gt, dist, ctx.seed, dtype)
    numbers = compare.train_numbers(program_side, ref)
    worst = numbers.pop("_worst")
    t_epoch = time.perf_counter()
    ref_epoch = train_ref.epoch_steps(cfg, gt, dist, ctx.seed, epoch, rec, dtype)
    numbers.update(compare.epoch_numbers(epoch_side, ref_epoch, args_batches))
    worst.update(numbers.pop("_worst"))
    ctx.log(f"[train] reference {time.perf_counter() - t_ref:.1f} s, of it epoch {epoch} step by step "
            f"{time.perf_counter() - t_epoch:.1f} s")
    ctx.log(f"[train] worst (step,) leaves {worst}")
    return Outcome(
        end_to_end={"train_epoch_ms": window_s / attempted * 1e3, "setup_s": setup_s},
        checks=numbers, attempted=attempted, failed=failed, memory_peak_bytes=peak, obs=obs,
        busy_s=busy_s, window_s=stretch_s, breakdown=breakdown,
    )

