"""CUDA graphs of the trainer's steps: the port's counterpart of the JAX
package's one-program chunks (``jax.jit`` of a ``lax.scan``,
``nvfpcc_tpu/train/loop.py:make_epochs_fn`` and
``nvfpcc_tpu/train/ctx_fit.py:run_chunk``).

A step is captured once into a ``torch.cuda.CUDAGraph`` and then replayed:
a replay launches the step's kernels, about 1,600 of them for a flagship
net step, with one host call. Everything a replay reads or writes lives in
tensors that exist before the capture and keep their storage (parameters,
``.grad``, optimizer state, the step's input and output buffers), so the
host changes a step's inputs by writing into those tensors between
replays. A graph executes nothing while it is captured: the caller replays
it for every step, the first included.

Before the capture the step runs eagerly on the capture's side stream, so
that cuDNN, cuBLAS and the allocator settle (the PyTorch documentation asks
for it). Those warm-up runs would advance the training state, so every
tensor the step mutates is copied first and put back after them, and each
generator the step draws from is put back to its state. A generator the
step draws from is registered with the graph: each replay then reads the
generator's seed and offset as they stand at the replay and advances the
offset as an eager step would, so ``manual_seed`` between replays restarts
the stream exactly as it does for eager draws.

Nothing falls back: a step that cannot be captured (a host sync, a copy
from pageable memory, a CPU tensor) raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch

# eager runs of a step on the capture stream before it is captured
WARMUP_RUNS = 2


def warm_up(
    step: Callable[[], None],
    mutated: Sequence[torch.Tensor],
    generators: Sequence[torch.Generator] = (),
    stream: torch.cuda.Stream | None = None,
) -> None:
    """Run ``step`` ``WARMUP_RUNS`` times (on ``stream`` when given, after
    the current stream's work), then put back every tensor in ``mutated``
    and every generator's state as they were before. Needs no CUDA without
    a ``stream``: the part of :func:`capture` a CPU test can run."""
    saved = [t.detach().clone() for t in mutated]
    gen_states = [g.get_state() for g in generators]
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
        for _ in range(WARMUP_RUNS):
            step()
    if stream is not None:
        torch.cuda.current_stream().wait_stream(stream)
    with torch.no_grad():
        for t, s in zip(mutated, saved):
            t.copy_(s)
    for g, s in zip(generators, gen_states):
        g.set_state(s)


def capture(
    step: Callable[[], None],
    mutated: Sequence[torch.Tensor],
    generators: Sequence[torch.Generator] = (),
    pool=None,
    stream: torch.cuda.Stream | None = None,
) -> torch.cuda.CUDAGraph:
    """Capture ``step`` (no arguments, no result: it reads and writes fixed
    tensors) into a new CUDA graph and return it, after :func:`warm_up`.
    ``mutated`` lists every tensor whose value the step changes and must
    survive the warm-up unchanged; ``generators`` every ``torch.Generator``
    it draws from. ``pool`` shares a memory pool with graphs that never run
    concurrently with this one (``graph.pool()``); ``stream`` is the side
    stream the warm-up and the capture run on (a new one by default)."""
    if not mutated or any(t.device.type != "cuda" for t in mutated):
        raise ValueError("a CUDA graph captures a step over CUDA tensors only")
    stream = stream if stream is not None else torch.cuda.Stream(mutated[0].device)
    warm_up(step, mutated, generators, stream)
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, pool=pool, stream=stream):
        step()
    return graph


def init_adam_state(opt: torch.optim.Adam) -> list:
    """Create the state ``torch.optim.Adam`` creates at a tensor's first
    step (zero moments, step 0), where it is missing, so that a captured
    Adam step finds it in place (a capture would otherwise allocate it from
    the graph's pool and zero it at every replay); returns every state
    tensor."""
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            if not opt.state[p]:
                opt.state[p] = {
                    "step": torch.zeros((), dtype=torch.float32, device=p.device),
                    "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                }
            out += [v for v in opt.state[p].values() if isinstance(v, torch.Tensor)]
    return out
