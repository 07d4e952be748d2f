"""The port's headline benchmark, the counterpart of the repo's ``bench.py``:
steady-state training-epoch wall-clock at the flagship configuration
(917 leaf blocks of 32^3 with structured synthetic occupancy, batch 16,
q=2, bf16 compute, per-batch net updates + the full-set embedding update),
plus warm encode and decode at the same scale, on one CUDA card.

    python -m nvfpcc_tpu_torch.tools.bench [--timed_chunks 3] [--platform cpu]

The setup is ``bench.py:main``'s with the port's pieces: ``ModelConfig()``,
``TrainConfig(batch_size=16)``, zero-residual params, ones embeddings, both
Adams, an all-ones block mask, ``NoiseSource(0, ...)``, q=2 throughout, and
for every epoch the batch plan of epoch 0 with epoch numbers 0..9 inside
each chunk of ten. ``bench.py`` runs a chunk of ten epochs as one compiled
program (``make_epochs_fn``); here a chunk runs as ``train`` runs one: ten
``train.loop.run_epoch`` calls on one ``EpochProgram`` (on the card the
gradients of its net step and embedding update are CUDA graphs, captured in
the warm-up chunk and replayed), then one host fetch of the chunk's metric
rows and the check
that they are finite, so ``epochs_per_dispatch`` is ten, bench.py's. One
warm-up chunk, then ``--timed_chunks`` timed chunks; the value is their
wall time over the timed epochs.

Output: the card's name and power limit first (``device.card_line``), then
one JSON line for each timed chunk, one with the compute dtype, block count
and peak device memory, and one with the codec's parity; last, the line of
``bench.py`` with its keys in its order. A non-finite metric row or an
encoder reconstruction that the decoder does not reproduce stops the run
with a message and exit status 1, before the last line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from nvfpcc_tpu_torch import codec
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig, TrainConfig
from nvfpcc_tpu_torch.device import PLATFORMS, card_line, resolve_device, set_train_numerics
from nvfpcc_tpu_torch.models import decoder as M
from nvfpcc_tpu_torch.octree.partition import leaf_origins
from nvfpcc_tpu_torch.train import loop as T
from nvfpcc_tpu_torch.utils.params import params_to_numpy

# copied from bench.py (which imports jax); tests/test_torch_bench.py holds
# them equal to the originals
REF_EPOCH_MS = 24_000.0  # inferred reference per-epoch cost (bench.py's docstring)
N_BLOCKS = 917
WARMUP_EPOCHS = 1  # warm-up chunks, as bench.py's loop uses it
TIMED_CHUNKS = 3
EPOCHS_PER_DISPATCH = 10  # bench.py's chunk: one program per eval interval; the port's chunk length
N_PTS = 875_031  # flagship-scale source point count (bpp denominator only; bench.py:codec_latency)


def synthetic_flagship_grids(seed: int = 0, n_blocks: int = N_BLOCKS):
    """Copy of ``bench.py:synthetic_flagship_grids`` (``n_blocks`` added,
    for tests): blocks of structured occupancy, a curved surface shell
    crossing each block (~3% occupied, like a real vox10 leaf block), with
    the distance grid the unsigned distance to that shell."""
    rng = np.random.default_rng(seed)
    nrm = rng.standard_normal((n_blocks, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    anchor = rng.uniform(10.0, 22.0, (n_blocks, 3))
    phase = rng.uniform(0, 2 * np.pi, (n_blocks, 1, 1, 1))
    g = (np.arange(32) + 0.5).astype(np.float32)
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")
    coords = np.stack([zz, yy, xx], -1)[None]  # (1,32,32,32,3)
    rel = coords - anchor[:, None, None, None, :]
    # signed distance to a gently-bowed plane; |grad| ~ 1 keeps the shell
    # one voxel thick (~32^2/32^3 ~ 3% occupancy)
    sd = (rel * nrm[:, None, None, None, :]).sum(-1)
    sd = sd + 2.0 * np.sin(0.12 * rel[..., 0] + phase) * np.cos(0.09 * rel[..., 1])
    gt = (np.abs(sd) < 0.52).astype(np.uint8)
    dist = np.maximum(np.abs(sd) - 0.52, 0.0).astype(np.float32) * (1 - gt)
    return gt, dist


def synthetic_origins(n_blocks: int, depth: int = 10, level: int = 5, seed: int = 1):
    """Copy of ``bench.py:synthetic_origins``: ``n_blocks`` distinct leaf
    origins in canonical traversal order."""
    rng = np.random.default_rng(seed)
    block = 1 << (depth - level)
    pts = rng.integers(0, 1 << level, (4 * n_blocks, 3)) * block
    origins = leaf_origins(pts.astype(np.int64), depth, level)
    if len(origins) < n_blocks:
        raise RuntimeError("synthetic origin pool too small")
    return origins[:n_blocks]


def _sync(device) -> None:
    """Wait for the card before a clock is read (a no-op on the host)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def codec_latency(mcfg, params: dict, emb: np.ndarray, device) -> tuple:
    """(encode_ms, decode_ms, points reconstructed) on the warm path: one
    warm-up encode and decode, then one timed encode and one timed decode
    (``bench.py:codec_latency``). ``params`` is the JAX-layout numpy tree a
    checkpoint holds. Exits 1 unless the decoded points equal the
    encoder's reconstruction."""
    ccfg = CodecConfig()
    origins = synthetic_origins(emb.shape[0], ccfg.depth, ccfg.level)

    def enc():
        return codec.encode(params, emb, origins, mcfg, ccfg, N_PTS, device)

    codec.decode(enc().pack, device)
    _sync(device)
    t0 = time.perf_counter()
    result = enc()
    _sync(device)
    encode_ms = (time.perf_counter() - t0) * 1000.0
    t0 = time.perf_counter()
    points, _ = codec.decode(result.pack, device)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1000.0
    if not np.array_equal(points, result.points):
        raise SystemExit(f"[bench] the decoder's {len(points)} points differ from the encoder's "
                         f"reconstruction ({len(result.points)} points)")
    return encode_ms, decode_ms, len(points)


def run_bench(device, timed_chunks: int = TIMED_CHUNKS, *, n_blocks: int = N_BLOCKS,
              chunk_epochs: int = EPOCHS_PER_DISPATCH, log=print) -> dict:
    """Train ``WARMUP_EPOCHS`` then ``timed_chunks`` chunks of
    ``chunk_epochs`` epochs (each chunk one fetch, as ``train`` runs one) on
    ``n_blocks`` synthetic flagship blocks, time the codec on the trained
    state; log the lines between the card line and the last, and return the
    last line's dict."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    gt, dist = synthetic_flagship_grids(n_blocks=n_blocks)
    mcfg = ModelConfig()  # ch=3, chanstr 8,16,8,8 (flagship)
    cfg = TrainConfig(batch_size=16)
    # bench.py does not go through train(), which sets the numerics
    set_train_numerics()
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    spec = M.build_model_spec(mcfg.ch, mcfg.channels, mcfg.seed_tag, mcfg.entropy_mode)
    net = T.initial_params(spec, mcfg, device)
    emb = M.init_embeddings(n_blocks, mcfg.ch, device).requires_grad_(True)
    opt, emb_opt = T.make_optimizers(cfg, net, emb)
    state = T.TrainState(net, opt, emb, emb_opt)
    n_total_pts = float(gt.sum())
    gt_d, dist_d = T._prep_dense(gt, dist, device)
    block_valid = torch.ones(n_blocks, device=device)
    noise = T.NoiseSource(0, spec, device)
    idx, mask = T.batch_plan(n_blocks, cfg.batch_size, cfg.shuffle, cfg.seed, 0)
    idx, mask = torch.from_numpy(idx).long(), torch.from_numpy(mask)
    program = T.EpochProgram(state, cfg, gt_d, dist_d, block_valid, n_total_pts, noise, graphs=cuda)

    def run_chunk():
        rows = [T.run_epoch(state, cfg, gt_d, dist_d, idx, mask, block_valid, n_total_pts, 2, noise, epoch,
                            program=program) for epoch in range(chunk_epochs)]
        rows = torch.stack(rows).cpu().numpy()  # the chunk's one fetch
        if not np.isfinite(rows).all():
            epoch = np.argwhere(~np.isfinite(rows))[0, 0]
            bad = sorted({T.METRIC_KEYS[j] for j in np.argwhere(~np.isfinite(rows[epoch]))[:, 1]})
            raise SystemExit(f"[bench] non-finite metrics {bad} at epoch {epoch} of a chunk")

    for _ in range(WARMUP_EPOCHS):
        run_chunk()
    _sync(device)
    chunk_s = []
    for chunk in range(timed_chunks):
        t0 = time.perf_counter()
        run_chunk()
        _sync(device)
        chunk_s.append(time.perf_counter() - t0)
        log(json.dumps({"chunk": chunk, "epochs": chunk_epochs, "ms_per_epoch": chunk_s[-1] / chunk_epochs * 1e3}))
    epoch_ms = sum(chunk_s) / (timed_chunks * chunk_epochs) * 1000.0
    log(json.dumps({"compute_dtype": cfg.compute_dtype, "n_blocks": n_blocks, "batch_size": cfg.batch_size,
                    "q": 2, "peak_device_bytes": torch.cuda.max_memory_allocated(device) if cuda else None}))

    encode_ms, decode_ms, n_rec = codec_latency(mcfg, params_to_numpy(state.net),
                                                state.emb.detach().cpu().numpy(), device)
    log(json.dumps({"parity": True, "n_points_rec": n_rec}))
    return {
        "metric": "train_epoch_flagship",
        "value": round(epoch_ms, 2),
        "unit": "ms",
        "vs_baseline": round(REF_EPOCH_MS / epoch_ms, 2),
        # the denominator is the 24 s/epoch the north-star arithmetic
        # implies, not a measured reference timing (it publishes none)
        "baseline_inferred": True,
        "epochs_per_dispatch": chunk_epochs,
        "encode_ms": round(encode_ms, 2),
        "decode_ms": round(decode_ms, 2),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--timed_chunks", type=int, default=TIMED_CHUNKS,
                    help=f"timed chunks of {EPOCHS_PER_DISPATCH} epochs, after one warm-up chunk")
    ap.add_argument("--platform", choices=PLATFORMS, default="default",
                    help="cpu: run on the host; default/device: the CUDA card, and fail without one")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.platform)
    print(card_line(device), flush=True)
    line = run_bench(device, args.timed_chunks, log=lambda s: print(s, flush=True))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
