"""The benchmark's inputs, made from ``--seed``: training grids, block
origins and the decode cell's weights and latents.

The grid construction is a copy of ``synthetic_flagship_grids`` in
``nvfpcc_tpu_torch/tools/bench.py`` (itself a copy of the root
``bench.py``), rewritten in PyTorch to run on the device in chunks of
blocks: each block is a curved surface shell crossing the 32^3 cube (about
3% occupied, like a real vox10 leaf block), and its distance grid is the
unsigned distance to that shell. ``synthetic_origins`` is a copy of the
same file's function, with its own Morton ordering.
"""

from __future__ import annotations

import math

import numpy as np
import torch

BLOCK = 32
SHELL = 0.52  # half thickness of the shell, in voxels


def block_params(gen: torch.Generator, n: int, device, dtype=torch.float64):
    """Per block: a unit normal, an anchor in [10, 22)^3 and a phase in
    [0, 2 pi), drawn from ``gen`` in three calls."""
    nrm = torch.randn((n, 3), generator=gen, device=device, dtype=dtype)
    nrm = nrm / nrm.norm(dim=1, keepdim=True)
    anchor = 10.0 + 12.0 * torch.rand((n, 3), generator=gen, device=device, dtype=dtype)
    phase = 2.0 * math.pi * torch.rand((n,), generator=gen, device=device, dtype=dtype)
    return nrm, anchor, phase


def flagship_grids(nrm, anchor, phase, chunk: int = 512):
    """(gt (n, 32, 32, 32) uint8, dist (n, 32, 32, 32) float32) of blocks
    given by :func:`block_params` (copied from ``synthetic_flagship_grids``
    in ``nvfpcc_tpu_torch/tools/bench.py``, a copy of the root ``bench.py``:
    the signed distance to a gently bowed plane, ``|grad| ~ 1``, keeps the
    shell one voxel thick)."""
    dev, dt = nrm.device, nrm.dtype
    g = torch.arange(BLOCK, device=dev, dtype=torch.float32).to(dt) + 0.5
    coords = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)  # (z, y, x)
    n = nrm.shape[0]
    gt = torch.empty((n, BLOCK, BLOCK, BLOCK), dtype=torch.uint8, device=dev)
    dist = torch.empty((n, BLOCK, BLOCK, BLOCK), dtype=torch.float32, device=dev)
    for i in range(0, n, chunk):
        s = slice(i, min(i + chunk, n))
        rel = coords[None] - anchor[s, None, None, None, :]
        sd = (rel * nrm[s, None, None, None, :]).sum(-1)
        sd = sd + 2.0 * torch.sin(0.12 * rel[..., 0] + phase[s, None, None, None]) * torch.cos(0.09 * rel[..., 1])
        occ = sd.abs() < SHELL
        gt[s] = occ.to(torch.uint8)
        dist[s] = (torch.clamp_min(sd.abs() - SHELL, 0.0) * (~occ)).float()
    return gt, dist


def training_grids(seed: int, n: int, device):
    """The grids of ``n`` blocks from ``seed``, on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return flagship_grids(*block_params(gen, n, device))


def morton_zyx(blocks: np.ndarray, bits: int) -> np.ndarray:
    """Z-order key of integer coordinates (x, y, z), z the most significant
    bit of each triple (the octree's child order z*4 + y*2 + x)."""
    b = np.asarray(blocks, np.uint64)
    key = np.zeros(len(b), np.uint64)
    for i in range(bits):
        for axis in range(3):
            key |= ((b[:, axis] >> np.uint64(i)) & np.uint64(1)) << np.uint64(3 * i + axis)
    return key


def synthetic_origins(n: int, depth: int, level: int, seed: int) -> np.ndarray:
    """``n`` distinct leaf-block origins in the octree's traversal order
    (copy of ``synthetic_origins`` in ``nvfpcc_tpu_torch/tools/bench.py``,
    a copy of the root ``bench.py``): 4n random block coordinates, the
    distinct ones sorted by Morton key, the first ``n``."""
    rng = np.random.default_rng(seed)
    shift = depth - level
    pts = rng.integers(0, 1 << level, (4 * n, 3)) << shift
    blocks = np.unique(pts >> shift, axis=0)
    if len(blocks) < n:
        raise RuntimeError("synthetic origin pool too small")
    order = np.argsort(morton_zyx(blocks, level), kind="stable")
    return (blocks[order] << shift)[:n].astype(np.int64)


def decode_params(rng: np.random.Generator, table: dict, cfg: dict, traffic: dict) -> dict:
    """A trained-like params tree for the decode cell (numpy float32, by
    format path): each transmitted layer's kernel residuals on the 1/16
    grid and its biases drawn at the traffic's ``resid`` and ``bias``
    ``[mean, sd]`` (a trained pack's), IGDN near its init; the latent
    generator set to pass the embedding through unchanged (identity kernel,
    zero bias, GDN with gamma at its bound and beta 1), so that integer
    embeddings are the integer latents the encoder codes; the channel
    Gaussians at the traffic's ``entropy_sigma``/``entropy_mu``. ``table``
    is the reference's layer table with its seeded inits: ``{name:
    (kernel_init, bias_init)}``."""
    ch = cfg["ch"]
    c0 = int(cfg["chanstr"].split(",")[0])
    p = {}
    for name, (k_init, b_init) in table.items():
        if name == "latent_gen":
            eye = np.eye(ch, dtype=np.float32).reshape(1, 1, 1, ch, ch)
            p["latent_gen/conv/kernel"] = (eye - k_init).astype(np.float32)
            p["latent_gen/conv/b"] = (-b_init).astype(np.float32)
            continue
        base = f"decoder/{name}"
        if name.endswith("_cls") and name != "conv2_cls":  # aux heads: training only
            p[f"{base}/kernel"] = np.zeros(k_init.shape, np.float32)
            p[f"{base}/b"] = np.zeros(b_init.shape, np.float32)
            continue
        (km, ksd), (bm, bsd) = traffic["resid"][name], traffic["bias"][name]
        p[f"{base}/kernel"] = (np.rint(rng.normal(km * 16, ksd * 16, k_init.shape)) / 16).astype(np.float32)
        p[f"{base}/b"] = rng.normal(bm, bsd, b_init.shape).astype(np.float32)
    ped = np.float32((2.0 ** -18) ** 2)
    p["decoder/igdn/beta"] = (np.sqrt(1 + ped) * rng.uniform(0.9, 1.1, c0)).astype(np.float32)
    p["decoder/igdn/gamma"] = np.sqrt(0.1 * np.eye(c0) + ped + np.abs(rng.normal(0, 0.01, (c0, c0)))).astype(
        np.float32)
    p["latent_gen/gdn/beta"] = np.sqrt(np.ones(ch, np.float32) + ped)
    p["latent_gen/gdn/gamma"] = np.zeros((ch, ch), np.float32)
    p["entropy/sigma"] = np.asarray(traffic["entropy_sigma"], np.float32)
    p["entropy/mu"] = np.asarray(traffic["entropy_mu"], np.float32)
    p["decoder/wrate/sigma"] = np.ones(1, np.float32)
    p["decoder/wrate/mu"] = np.zeros(1, np.float32)
    return p
