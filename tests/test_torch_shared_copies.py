"""The port's copies of the JAX package's jax-free format modules, held
byte-equal (or value-equal) to their originals on seeded inputs: the range
coder, the context-model coder and the Huffman coder, the octree
partitioner (numpy and native paths),
PLY I/O, the seed stream, the configs, the trainer's batch plan, the CLI's
auto gates and the numpy helpers of the D2 metric. A pack or a
checkpoint written by either package must read the same in the other."""

import argparse
import dataclasses

import numpy as np
import pytest

import nvfpcc_tpu.cli as jax_cli
import nvfpcc_tpu.config as jax_config
from nvfpcc_tpu.coder import ctx_coder as jax_ctx
from nvfpcc_tpu.coder import huffman as jax_huffman
from nvfpcc_tpu.codec import weights as jax_weights
from nvfpcc_tpu.coder import range_coder as jax_rc
from nvfpcc_tpu.io import ply as jax_ply
from nvfpcc_tpu.metrics import d2 as jax_d2
from nvfpcc_tpu.octree import native as jax_native
from nvfpcc_tpu.octree import partition as jax_part
from nvfpcc_tpu.train import loop as jax_loop
from nvfpcc_tpu.utils import seeds as jax_seeds
from nvfpcc_tpu_torch import cli as port_cli
from nvfpcc_tpu_torch import codec as port_codec
from nvfpcc_tpu_torch import config as port_config
from nvfpcc_tpu_torch.coder import ctx_coder as port_ctx
from nvfpcc_tpu_torch.coder import huffman as port_huffman
from nvfpcc_tpu_torch.coder import range_coder as port_rc
from nvfpcc_tpu_torch.io import ply as port_ply
from nvfpcc_tpu_torch.metrics import d2 as port_d2
from nvfpcc_tpu_torch.octree import native as port_native
from nvfpcc_tpu_torch.octree import partition as port_part
from nvfpcc_tpu_torch.train import loop as port_loop
from nvfpcc_tpu_torch.utils import seeds as port_seeds


def _cloud(seed: int, n: int = 3000, depth: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    c, r = (1 << depth) / 2, (1 << depth) * 0.35
    pts = np.stack([c + r * np.cos(t), c + r * np.sin(t), c + 0.5 * r * np.sin(2 * t)], -1)
    pts += rng.normal(0, 2.0, pts.shape)
    return np.unique(np.clip(np.rint(pts), 0, (1 << depth) - 1).astype(np.int64), axis=0)


# ---------------------------------------------------------------- range coder


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_range_coder_streams_byte_equal_and_cross_decode(seed):
    rng = np.random.default_rng(seed)
    ch = int(rng.integers(1, 6))
    sigma = rng.uniform(0.05, 30.0, ch).astype(np.float32)
    mu = rng.uniform(-5, 5, ch).astype(np.float32)
    lat = np.rint(np.clip(rng.normal(mu, sigma * 3, (40, 2, 2, 2, ch)), -512, 512)).astype(np.float32)
    cum_j = jax_rc.build_cum_tables(sigma, mu + jax_rc.OFFSET)
    cum_p = port_rc.build_cum_tables(sigma, mu + port_rc.OFFSET)
    np.testing.assert_array_equal(cum_p, cum_j)
    pj, pp = jax_rc.encode_latents(lat, sigma, mu), port_rc.encode_latents(lat, sigma, mu)
    assert pp["stream"] == pj["stream"] and pp["shape"] == pj["shape"]
    np.testing.assert_array_equal(port_rc.decode_latents(pj), lat)
    np.testing.assert_array_equal(jax_rc.decode_latents(pp), lat)
    # the weight-stream tables (empirical histograms), raw symbols, table ids
    counts = rng.integers(0, 50, (3, 33)) + (np.arange(33) == 16)
    cum_c = port_rc.build_cum_from_counts(counts)
    np.testing.assert_array_equal(cum_c, jax_rc.build_cum_from_counts(counts))
    ids = rng.integers(0, 3, 500).astype(np.int32)
    syms = rng.integers(0, 33, 500).astype(np.int32)
    stream = port_rc.encode(syms, ids, cum_c)
    assert stream == jax_rc.encode(syms, ids, cum_c)
    np.testing.assert_array_equal(jax_rc.decode(stream, ids, cum_c), syms)
    with port_rc.StreamingDecoder(stream) as dec:
        got = np.concatenate([dec.decode(ids[:200], cum_c), dec.decode(ids[200:], cum_c)])
    np.testing.assert_array_equal(got, syms)


def test_range_coder_mixture_and_factorized_tables_equal():
    rng = np.random.default_rng(3)
    ch = 3
    sigma = rng.uniform(0.2, 8.0, (2, ch)).astype(np.float32)
    mu = rng.uniform(-3, 3, (2, ch)).astype(np.float32)
    logit = rng.normal(0, 1, ch).astype(np.float32)
    np.testing.assert_array_equal(
        port_rc.build_cum_tables_gmm(sigma, mu, logit), jax_rc.build_cum_tables_gmm(sigma, mu, logit)
    )
    f = port_rc.FACTORIZED_FILTERS
    params = {}
    for i in range(len(f) - 1):
        params[f"matrix_{i}"] = rng.normal(0, 1, (ch, f[i], f[i + 1])).astype(np.float32)
        params[f"bias_{i}"] = rng.normal(0, 1, (ch, f[i + 1])).astype(np.float32)
        params[f"factor_{i}"] = rng.normal(0, 1, (ch, f[i + 1])).astype(np.float32)
    np.testing.assert_array_equal(
        port_rc.build_cum_tables_factorized(params, ch),
        jax_rc.build_cum_tables_factorized(params, ch),
    )


# ------------------------------------------------------- context-model coder


@pytest.mark.parametrize("mode,tail", [("ctx", 0), ("ctx_ar", 3)])
def test_ctx_coder_payloads_and_streams_byte_equal(mode, tail):
    """The ctx payload, the integer predictor and the latent streams of the
    port's copy equal the original's on the same specs and params, and each
    package decodes the other's stream."""
    from nvfpcc_tpu.models import decoder as jax_m
    from nvfpcc_tpu_torch.models import decoder as port_m

    kw = dict(entropy_mode=mode, ctx_hidden=8, ctx_tail=tail)
    jspec, pspec = jax_m.build_model_spec(2, (4, 8, 4, 4), **kw), port_m.build_model_spec(2, (4, 8, 4, 4), **kw)
    rng = np.random.default_rng(4)
    ep = {n: {"kernel": (rng.integers(-7, 8, jspec.specs[n].kernel_shape) / 16).astype(np.float32),
              "b": rng.normal(0, 0.4, jspec.specs[n].out_ch).astype(np.float32)} for n in ("ctx1", "ctx2")}
    pj, pp = jax_ctx.build_ctx_payload(jspec, ep, 16), port_ctx.build_ctx_payload(pspec, ep, 16)
    assert pp["res"]["bit_stream"] == pj["res"]["bit_stream"] and pp["qp"] == pj["qp"] == 16
    assert pp["res"]["min_sym"] == pj["res"]["min_sym"] and pp["res"]["element_length"] == pj["res"]["element_length"]
    np.testing.assert_array_equal(pp["res"]["counts"], pj["res"]["counts"])
    assert port_ctx.ctx_payload_bits(pp) == jax_ctx.ctx_payload_bits(pj)
    ij, ip = jax_ctx.ctx_ints_from_payload(jspec, pj), port_ctx.ctx_ints_from_payload(pspec, pj)
    assert set(ij) == set(ip)
    for k in ij:
        np.testing.assert_array_equal(ip[k], ij[k])
    lat = np.rint(rng.normal(0, 4, (30, 2, 2, 2, 2))).astype(np.int64)
    for a, b in zip(port_ctx.predict_int(lat, ip), jax_ctx.predict_int(lat, ij)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port_ctx.ExactPredictor(ip)(lat), jax_ctx.predict_int(lat, ij)):
        np.testing.assert_array_equal(a, b)
    ar = mode == "ctx_ar"
    ej, epo = jax_ctx.encode_latents_ctx(lat, ij, ar), port_ctx.encode_latents_ctx(lat, ip, ar)
    assert epo["stream"] == ej["stream"] and epo["shape"] == ej["shape"] and epo["n_clamped"] == ej["n_clamped"]
    np.testing.assert_array_equal(port_ctx.decode_latents_ctx(ej["stream"], ej["shape"], ip, ar), lat)
    np.testing.assert_array_equal(jax_ctx.decode_latents_ctx(epo["stream"], epo["shape"], ij, ar), lat)
    for name in ("KSCALE", "OUT2_SCALE", "MU_GRID", "SIGMA_LEVELS", "_CAUSAL_OFFSETS", "_RASTER"):
        assert getattr(port_ctx, name) == getattr(jax_ctx, name), name
    np.testing.assert_array_equal(port_ctx._SIGMA_BOUNDS, jax_ctx._SIGMA_BOUNDS)
    np.testing.assert_array_equal(port_ctx._SIGMA_VALS, jax_ctx._SIGMA_VALS)


# -------------------------------------------------------------------- huffman


@pytest.mark.parametrize("seed", [0, 1])
def test_huffman_packs_byte_equal_and_cross_decode(seed):
    rng = np.random.default_rng(seed)
    tensors = [rng.integers(-6, 7, s) * (rng.uniform(0, 1, s) < 0.4) for s in ((3, 3, 3, 2, 4), (17,))]
    pj, pp = jax_huffman.encode_tensors(tensors), port_huffman.encode_tensors(tensors)
    assert pp["bit_stream"] == pj["bit_stream"]
    assert pp["element_length"] == pj["element_length"] and pp["shape_list"] == pj["shape_list"]
    for k in ("symbols", "lengths"):
        np.testing.assert_array_equal(pp["codebook"][k], pj["codebook"][k])
        assert pp["codebook"][k].dtype == pj["codebook"][k].dtype
    for a, b in zip(port_huffman.decode_tensors(pj), tensors):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax_huffman.decode_tensors(pp), tensors):
        np.testing.assert_array_equal(a, b)
    # the pure-Python walk the original keeps beside its native decoder
    cb = port_huffman.HuffmanCodebook.from_dict(pp["codebook"])
    np.testing.assert_array_equal(
        port_huffman._decode_py(pp["bit_stream"], cb, pp["element_length"]),
        np.concatenate([t.reshape(-1) for t in tensors]),
    )


# --------------------------------------------------------------------- octree


@pytest.mark.parametrize("use_native", [False, True])
def test_octree_equal_on_numpy_and_native_paths(use_native):
    pts = _cloud(5)
    depth, level = 7, 3
    if use_native:
        assert port_native.available() and jax_native.available()
        np.testing.assert_array_equal(
            port_native.leaf_origins(pts, depth, level), jax_native.leaf_origins(pts, depth, level)
        )
        assert port_native.subtree_occupancy_string(pts, depth, level) == (
            jax_native.subtree_occupancy_string(pts, depth, level)
        )
    want = jax_part.leaf_origins(pts, depth, level, use_native=use_native)
    got = port_part.leaf_origins(pts, depth, level, use_native=use_native)
    np.testing.assert_array_equal(got, want)
    s = port_part.subtree_occupancy_string(pts, depth, level)
    assert s == jax_part.subtree_occupancy_string(pts, depth, level)
    trimmed = port_part.subtree_occupancy_string(got, depth, level - 1)
    for leaf_children, string in ((True, s), (False, trimmed)):
        np.testing.assert_array_equal(
            port_part.occupancy_to_origins(string, depth, level, leaf_children),
            jax_part.occupancy_to_origins(string, depth, level, leaf_children),
        )
    bits = port_part.pack_occupancy_bits(trimmed)
    assert bits == jax_part.pack_occupancy_bits(trimmed)
    assert port_part.unpack_occupancy_bits(bits, len(trimmed)) == trimmed


# ------------------------------------------------------------------------ PLY


@pytest.mark.parametrize("ascii_", [True, False])
def test_ply_written_byte_equal_and_read_back(tmp_path, ascii_):
    pts = _cloud(6).astype(np.float64) + np.random.default_rng(6).uniform(0, 1, (1, 3))
    a, b = tmp_path / "jax.ply", tmp_path / "port.ply"
    jax_ply.write_ply_points(str(a), pts, ascii=ascii_)
    port_ply.write_ply_points(str(b), pts, ascii=ascii_)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(port_ply.read_ply_points(str(a)), jax_ply.read_ply_points(str(b)))


# ---------------------------------------------------------------------- seeds


@pytest.mark.parametrize("tag", [port_seeds.DEFAULT_TAG, "nvfpcc-tpu/other-stream"])
def test_seed_streams_equal(tag):
    assert port_seeds.DEFAULT_TAG == jax_seeds.DEFAULT_TAG
    kj, kp = jax_seeds.base_key(tag), port_seeds.base_key(tag)
    for index, label in ((0, "kernel"), (3, "bias"), ("deconv1", "noise")):
        kj2 = jax_seeds.sub_key(jax_seeds.layer_key(kj, index), label)
        kp2 = port_seeds.sub_key(port_seeds.layer_key(kp, index), label)
        assert tuple(kp2) == tuple(kj2)
        shape = (3, 3, 3, 2, 5)
        np.testing.assert_array_equal(port_seeds.uniform(kp2, shape, -1, 2), jax_seeds.uniform(kj2, shape, -1, 2))
        np.testing.assert_array_equal(
            port_seeds.kaiming_uniform(kp2, shape, 54), jax_seeds.kaiming_uniform(kj2, shape, 54)
        )
        np.testing.assert_array_equal(
            port_seeds.uniform_bias(kp2, (5,), 54), jax_seeds.uniform_bias(kj2, (5,), 54)
        )


# ------------------------------------------------------------ configs and CLI


@pytest.mark.parametrize("name", ["ModelConfig", "CodecConfig", "TrainConfig", "ExperimentConfig"])
def test_config_defaults_equal(name):
    port, orig = getattr(port_config, name)(), getattr(jax_config, name)()
    assert dataclasses.asdict(port) == dataclasses.asdict(orig)
    assert [(f.name, f.type) for f in dataclasses.fields(port)] == [
        (f.name, f.type) for f in dataclasses.fields(orig)
    ]
    if name == "ModelConfig":
        assert port.channels == orig.channels


@pytest.mark.parametrize("shuffle", ["stride", "random", "none"])
def test_batch_plan_equal(shuffle):
    for n_blocks, batch, seed, epoch in ((6, 4, 0, 0), (1314, 16, 0, 3), (16, 16, 2, 9), (5, 8, 1, 1)):
        want = jax_loop.batch_plan(n_blocks, batch, shuffle, seed, epoch)
        got = port_loop.batch_plan(n_blocks, batch, shuffle, seed, epoch)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype and a.shape == b.shape
    idx, mask = port_loop.batch_plan(1314, 16, shuffle, 0, 0)
    assert idx.shape == (83, 16) and int(mask.sum()) == 1314 and mask[-1].tolist() == [1, 1] + [0] * 14


def test_cli_auto_train_gate_equal():
    for level in (2, 5, 6, 7):
        for n in (0, 8_000, 23_136, 92_000, 93_500, 127_824, 10**6):
            assert port_cli.resolve_auto_train(level, n) == jax_cli.resolve_auto_train(level, n)
    assert port_cli.resolve_auto_train(6, 127_824) == "ctx"
    assert port_cli.resolve_auto_train(5, 127_824) == "channel"


def test_cli_auto_gates_equal():
    assert port_cli.CTX_POST_ECONOMICS == jax_cli.CTX_POST_ECONOMICS
    assert (port_cli._DEFAULT_CH, port_cli._DEFAULT_CHANSTR) == (
        jax_cli._DEFAULT_CH, jax_cli._DEFAULT_CHANSTR,
    )
    modes = ("channel", "spatio", "ctx", "ctx_ar", "gmm", "factorized")
    for n in (0, 1, 8_000, 23_136, 92_000, 93_500, 127_824, 10**6):
        assert port_cli.ctx_post_break_even(n) == jax_cli.ctx_post_break_even(n)
        for mode in modes:
            for hidden in (8, 32):
                assert port_cli.resolve_auto_encode(mode, hidden, n) == (
                    jax_cli.resolve_auto_encode(mode, hidden, n)
                )
    assert port_cli.artifact_path("/a/b/cloud.ply", 10, 5) == jax_cli.artifact_path("/a/b/cloud.ply", 10, 5)


def test_cli_model_flags_equal():
    def flags(add):
        p = argparse.ArgumentParser()
        add(p)
        return [(a.dest, a.default, a.choices, a.type, a.help) for a in p._actions]

    assert flags(port_cli._add_model) == flags(jax_cli._add_model)


# ------------------------------------------------------------------------- D2


@pytest.mark.parametrize("seed", [0, 1])
def test_d2_numpy_helpers_equal(seed):
    """Key packing, the windowed-PCA normals (bit for bit) and the integer
    sphere offsets; the NN vectors recovered from one EDT distance field."""
    pts = _cloud(seed, n=1500, depth=6)
    np.testing.assert_array_equal(port_d2._keys(pts), jax_d2._keys(pts))
    for radius in (1, 2):
        pn, pv = port_d2.estimate_normals(pts, radius)
        jn, jv = jax_d2.estimate_normals(pts, radius)
        np.testing.assert_array_equal(pn, jn)
        np.testing.assert_array_equal(pv, jv)
    for v in (0, 1, 2, 3, 9, 50, 125, 3969):
        assert port_d2._sphere_offsets(v, 63) == jax_d2._sphere_offsets(v, 63)
    other = _cloud(seed + 7, n=1500, depth=6)
    ve, vj = port_d2._vectors_at(pts, other, jax_d2._nn_sq_dists(pts, other, 20, "cpu"), 20)
    je, jj = jax_d2.nn_vectors(pts, other, 20, "cpu")
    np.testing.assert_array_equal(ve, je)
    np.testing.assert_array_equal(vj, jj)


# -------------------------------------------------------- weights, check_quantized


@pytest.mark.parametrize("ctx", [False, True])
def test_check_quantized_equal(ctx):
    """On the 1/qp grid, 5e-6 off it (inside the 1e-4 tolerance on k * qp),
    and 0.01 off it, for the channel and the ctx tree, at qp 16 and 8."""
    from nvfpcc_tpu_torch.models import decoder as TM
    from nvfpcc_tpu_torch.utils.params import params_to_numpy

    spec = TM.build_model_spec(2, (4, 8, 4, 4), entropy_mode="ctx" if ctx else "channel")
    rng = np.random.default_rng(3)
    tree = params_to_numpy(TM.init_params(spec))
    for name in TM.TRANSMITTED_KERNELS:
        k = tree["decoder"][name]["kernel"]
        tree["decoder"][name]["kernel"] = (k + rng.normal(0, 0.2, k.shape)).astype(np.float32)
    for qp in (16, 8):
        on = port_codec.quantize_residuals(tree, qp)
        near = {**on, "decoder": {**on["decoder"], "up0": {
            **on["decoder"]["up0"], "kernel": on["decoder"]["up0"]["kernel"] + np.float32(5e-6)}}}
        off = {**on, "decoder": {**on["decoder"], "conv2": {
            **on["decoder"]["conv2"], "kernel": on["decoder"]["conv2"]["kernel"] + np.float32(0.01)}}}
        for t, want in ((tree, False), (on, True), (near, True), (off, False)):
            assert port_codec.check_quantized(t, qp) is jax_weights.check_quantized(t, qp) is want
