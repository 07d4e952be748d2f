"""Post-hoc context-predictor fitting ("ctx_post", port of
``nvfpcc_tpu/train/ctx_fit.py``): entropy-upgrade a trained model without
touching its latents.

The masked-conv predictor of a ctx/ctx_ar spec is fitted AFTER training, on
the frozen rounded latents:

- reconstruction is untouched (same latents, same decoder, same D1),
- the predictor minimizes the actual discrete coding objective (Gaussian
  bits of the already-rounded integers) plus the transmitted-kernel cost
  under the checkpoint's weight-rate model,
- the fitted kernels ship in the standard ctx/ctx_ar pack payload; the
  decoder cannot tell how the predictor was trained.

Two phases: an unquantized (q=0) fit from the feature init with a
cosine-decayed lr, then a quantization-aware (q=2, STE) finetune. Each
phase runs in 250-step chunks with one host fetch a chunk (the last step's
stream bits), which decides the early stop; a phase of n steps runs
``max(1, n // 250)`` whole chunks. On a CUDA card a phase's step (the
objective, its gradient and Adam, with the lr a device tensor) is a CUDA
graph replayed 250 times a chunk (``train/graphs.py``): the counterpart of
the JAX package's ``run_chunk``, one compiled ``lax.scan`` a chunk. TF32
stays off: reduced-precision matmuls measurably worsened the fitted rate in
the JAX package.

Each phase is one ``ctx_fit.phase`` span (``utils/trace.py``), outside the
captured step, counting its ``q`` and the steps it took.

Whatever device fits, the pack is valid: the fitted kernels are quantized
on the host and both coder ends predict in exact integers, so encode and
decode agree however the fit's floats were ordered.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from nvfpcc_tpu_torch.device import set_train_numerics
from nvfpcc_tpu_torch.models import decoder as M
from nvfpcc_tpu_torch.ops import rate
from nvfpcc_tpu_torch.ops.ste import bypass_round16
from nvfpcc_tpu_torch.train.graphs import capture, init_adam_state
from nvfpcc_tpu_torch.utils import trace
from nvfpcc_tpu_torch.utils.params import params_from_numpy, params_to_numpy

CHUNK = 250  # steps between host fetches (and early-stop checks)
FINETUNE_LR = 2e-3  # peak lr of the q=2 phase
# a phase stops after this many consecutive flat chunks: the two-layer
# objective improves in bursts, so one flat chunk is not convergence
EARLY_STOP_PATIENCE = 2


def _adam(params, lr: float, device: torch.device) -> torch.optim.Adam:
    """optax.adam's defaults. On a CUDA device ``capturable``, with the lr a
    0-dim tensor on the card that :func:`_set_lr` fills before each step:
    the step count, the bias corrections and the lr are then device values
    that a captured step reads at every replay (a float lr would be baked
    into the graph), and the eager fit on the card takes the same Adam, so
    both give the same bits. The CPU keeps the plain Adam with a float lr."""
    if device.type == "cuda":
        lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
        return torch.optim.Adam(params, lr=lr_t, betas=(0.9, 0.999), eps=1e-8, foreach=True, capturable=True)
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _set_lr(opt: torch.optim.Adam, lr: float) -> None:
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


def cosine_lr(peak_lr: float, decay_steps: int, count: int) -> float:
    """optax's ``cosine_decay_schedule(peak_lr, decay_steps)`` (alpha 0) at
    ``count`` updates already made."""
    frac = min(count, decay_steps) / decay_steps
    return peak_lr * 0.5 * (1.0 + math.cos(math.pi * frac))


def fit_ctx_predictor(
    spec: M.ModelSpec,
    lat_int: np.ndarray,
    device,
    wrate: Optional[dict] = None,
    steps: int = 3000,
    lr: float = 3e-2,
    finetune_steps: int = 1000,
    finetune_lr: float = FINETUNE_LR,
    payload_weight: float = 1.0,
    init_entropy: Optional[dict] = None,
    early_stop: float = 2e-3,
    early_stop_patience: int = EARLY_STOP_PATIENCE,
    log: Callable[[str], None] = print,
    graphs: Optional[bool] = None,
) -> dict:
    """Fit the spec's masked-conv predictor on frozen integer latents
    ``lat_int`` (N, 2, 2, 2, ch) on ``device``; returns the fitted entropy
    subtree as a numpy tree (float; the codec quantizes it to the 1/qp grid).
    The JAX function's arguments, with ``device`` for its ``backend``.

    The fit starts from :func:`models.decoder.ctx_feature_init`, or from
    ``init_entropy`` (a tree holding ``ctx1``/``ctx2``) as a warm start.
    ``wrate`` (the checkpoint's scalar-Gaussian weight-rate params) prices
    the mask-visible kernel residuals, weighted by ``payload_weight``, so the
    fit optimizes total pack bits. The q=2 phase peaks at ``finetune_lr``.
    ``early_stop`` ends a phase when ``early_stop_patience`` consecutive
    chunks each improve the stream-bit estimate by less than this fraction
    (0 disables). ``graphs`` runs the steps as CUDA graphs: None means on
    exactly when ``device`` is CUDA; True on another device raises."""
    if spec.entropy_mode not in M.CTX_MODES:
        raise ValueError(f"ctx_post needs a ctx-mode spec, got {spec.entropy_mode}")
    device = torch.device(device)
    if graphs and device.type != "cuda":
        raise ValueError(f"CUDA graphs of the fit need a CUDA device, not {device}")
    graphs = device.type == "cuda" if graphs is None else bool(graphs)
    set_train_numerics()
    ep0 = M.ctx_feature_init(spec) if init_entropy is None else {k: init_entropy[k] for k in M.CTX_KERNELS}
    pred = params_from_numpy(M.CtxPredictor(spec), ep0).to(device)
    x = torch.as_tensor(np.asarray(lat_int, np.float32), device=device)
    wr = None
    if wrate is not None:
        wr = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in wrate.items()}

    def objective(q: int):
        mu, sigma = pred(x, q)
        bits = rate.gaussian_bits(x, sigma, mu, step=1.0).sum()
        payload = 0.0
        if wr is not None:
            for m in (pred.ctx1, pred.ctx2):
                k = m.kernel.reshape(-1)[m.mask_idx]
                payload = payload + rate.scalar_gaussian_rate(wr, bypass_round16(k))
        return bits + payload_weight * payload, bits

    params = list(pred.parameters())
    bits_buf = torch.zeros((), device=device)  # the last step's stream bits

    def run_phase(q: int, n_steps: int, peak_lr: float, tag: str) -> int:
        # optax.adam's defaults; a fresh optimizer state for each phase
        opt = _adam(params, peak_lr, device)
        for p in params:
            p.grad = torch.zeros_like(p)

        def step():
            loss, bits = objective(q)
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p, g in zip(params, grads):
                    p.grad.copy_(g)
            opt.step()
            with torch.no_grad():
                bits_buf.copy_(bits)

        graph = None
        if graphs:
            graph = capture(step, [*params, *init_adam_state(opt), bits_buf])
        decay = max(n_steps, 1)
        n_chunks = max(1, n_steps // CHUNK)
        prev, below, count = None, 0, 0
        for c in range(n_chunks):
            for _ in range(CHUNK):
                _set_lr(opt, cosine_lr(peak_lr, decay, count))
                if graph is None:
                    step()
                else:
                    graph.replay()
                count += 1
            bits = float(bits_buf)  # the chunk's one host fetch
            if c == 0 or c + 1 == n_chunks or (c + 1) % 4 == 0:
                log(f"[ctx_fit] {tag} chunk {c + 1}/{n_chunks}: ~{bits:.0f} stream bits")
            if early_stop and prev is not None and bits > prev * (1.0 - early_stop):
                below += 1
                if below >= early_stop_patience:
                    log(f"[ctx_fit] {tag} converged at chunk {c + 1}/{n_chunks} ({below} chunks "
                        f"<{early_stop:.1%} improvement), stopping early")
                    break
            else:
                below = 0
            prev = bits
        for p in params:
            p.grad = None
        trace.count(q=q, steps=count)
        return count

    with torch.no_grad():
        _, bits0 = objective(2)
    log(f"[ctx_fit] {spec.entropy_mode} hidden={spec.ctx_hidden}: start {float(bits0):.0f} "
        f"stream bits on {lat_int.shape[0]} blocks ({device})")
    t0 = time.time()
    with trace.span("ctx_fit.phase", device=True):
        n = run_phase(0, steps, lr, f"phase 1 (q0, {steps} steps)")
    if finetune_steps:
        with trace.span("ctx_fit.phase", device=True):
            n += run_phase(2, finetune_steps, finetune_lr, f"phase 2 (q2 STE, {finetune_steps} steps)")
    secs = time.time() - t0  # the last chunk's fetch waited for the device
    log(f"[ctx_fit] {n} steps in {secs:.2f}s ({n / secs:.1f} steps/s)")
    return params_to_numpy(pred)


def latents_from_checkpoint(spec: M.ModelSpec, params: dict, emb: np.ndarray, device) -> np.ndarray:
    """Rounded integer latents of a trained (params, emb) pair: the exact
    values the codec codes (host rint of the device latent)."""
    gen = params_from_numpy(M.LatentGen(spec), params["latent_gen"]).to(device)
    with torch.no_grad():
        lat = gen(torch.as_tensor(np.asarray(emb, np.float32), device=device)).cpu().numpy()
    return np.rint(lat.astype(np.float64)).astype(np.int64)


def upgrade_params_to_ctx(
    spec: M.ModelSpec,
    params: dict,
    emb: np.ndarray,
    device,
    steps: int = 3000,
    lr: float = 3e-2,
    early_stop: float = 2e-3,
    log: Callable[[str], None] = print,
) -> dict:
    """A params tree whose entropy subtree is a freshly fitted ctx predictor
    for ``spec`` (any source entropy mode; decoder and latent generator, and
    so the reconstruction, are untouched). Always starts from the feature
    init, even when refitting a ctx checkpoint: the co-trained predictor's
    basin stalls near the marginal rate."""
    lat_int = latents_from_checkpoint(spec, params, emb, device)
    ep = fit_ctx_predictor(
        spec, lat_int, device, wrate=params["decoder"].get("wrate"), steps=steps, lr=lr,
        early_stop=early_stop, log=log,
    )
    return {**params, "entropy": ep}
