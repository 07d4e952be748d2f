"""The port's ctx_ar entropy model against the benchmark's plain reference
(``benchmark/reference/ctx_ar.py``), which builds the predictor from its
equations and imports nothing of the port: the float predictor
(``models/decoder.py:CtxPredictor``), the decode order's causality, the
host coder's integer predictor (``coder/ctx_coder.py:ExactPredictor``) and
a ctx_ar pack through ``codec.encode`` and ``codec.decode``.

On the CPU, one torch thread, toy sizes.
"""

import numpy as np
import pytest
import torch

from benchmark.generators import decode_params, synthetic_origins
from benchmark.reference import compare
from benchmark.reference import ctx_ar as R
from benchmark.reference.nvfpcc import Model, reconstruct
from nvfpcc_tpu_torch import codec
from nvfpcc_tpu_torch.coder import ctx_coder as CTX
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig
from nvfpcc_tpu_torch.models import decoder as M
from nvfpcc_tpu_torch.utils.params import params_from_numpy, unflatten_tree
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

CH = 3
SHAPES = [(32, 24), (8, 4)]  # (hidden, tail): the vox11 pack's, and a toy one


def residuals(hidden, seed, scale=0.3):
    """Seeded kernel residuals on the 1/16 grid and biases of both layers."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, (cin, cout) in (("ctx1", (CH, hidden)), ("ctx2", (hidden, 2 * CH))):
        k = np.rint(rng.normal(0, scale, (3, 3, 3, cin, cout)) * 16) / 16
        out[name] = {"kernel": k.astype(np.float32), "b": rng.normal(0, 0.5, cout).astype(np.float32)}
    return out


def latents(n, seed, spread=12):
    rng = np.random.default_rng(seed)
    return rng.integers(-spread, spread + 1, (n, 2, 2, 2, CH)).astype(np.float32)


def port_predictor(hidden, tail, res):
    spec = M.build_model_spec(CH, entropy_mode="ctx_ar", ctx_hidden=hidden, ctx_tail=tail)
    return spec, params_from_numpy(M.CtxPredictor(spec), res).eval()


@pytest.mark.parametrize("hidden,tail", SHAPES)
def test_the_port_predicts_as_the_reference(hidden, tail):
    """The same f32 arithmetic, summed in another order at most: each
    output sums up to 27 * 32 products of magnitude about 10, so 1e-4 of
    the output's scale bounds the rounding (2^-24 a term) with room
    (measured on the CPU: equal bit for bit)."""
    res = residuals(hidden, seed=hidden + tail)
    spec, pred = port_predictor(hidden, tail, res)
    ref = R.CtxAR(CH, hidden, tail)
    m1, m2 = R.masks(CH, hidden, tail)
    np.testing.assert_array_equal(np.broadcast_to(spec.specs["ctx1"].mask, m1.shape), m1)
    np.testing.assert_array_equal(np.broadcast_to(spec.specs["ctx2"].mask, m2.shape), m2)
    y = torch.from_numpy(latents(16, seed=3))
    with torch.no_grad():
        mu_p, sigma_p = pred(y, q=2)
    mu_r, sigma_r = ref.predict(y, ref.kernels(res))
    for p, r in ((mu_p, mu_r), (sigma_p, sigma_r)):
        scale = float(r.abs().max())
        torch.testing.assert_close(p, r, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("hidden,tail", SHAPES)
def test_no_prediction_sees_its_own_step_or_a_later_one(hidden, tail):
    """Changing the latent of decode step s (position p, channel c) moves
    no (mu, sigma) of a step up to s, in the port and in the reference,
    and moves some later one (except after the last step)."""
    res = residuals(hidden, seed=7)
    _spec, pred = port_predictor(hidden, tail, res)
    ref = R.CtxAR(CH, hidden, tail)
    kernels = ref.kernels(res)

    def port(y):
        with torch.no_grad():
            return torch.cat(pred(y, q=2), -1)

    def plain(y):
        return torch.cat(ref.predict(y, kernels), -1)

    y = torch.from_numpy(latents(6, seed=11))
    for f in (port, plain):
        base = f(y).reshape(6, 8, 2, CH)  # (block, position, mu|sigma, channel)
        for p in range(8):
            for c in range(CH):
                z = y.clone()
                z.reshape(6, 8, CH)[:, p, c] += 5.0
                moved = (f(z).reshape(6, 8, 2, CH) != base).any(dim=(0, 2))  # (position, channel)
                steps = [R.step_of(q, d, CH) for q in range(8) for d in range(CH) if moved[q, d]]
                s = R.step_of(p, c, CH)
                assert all(t > s for t in steps), (f.__name__, p, c, steps)
                assert steps or s == 8 * CH - 1, (f.__name__, p, c)


def test_the_integer_predictor_follows_the_reference():
    """``ExactPredictor`` on a pack's integers against the reference on the
    same kernels dequantized (scale 4096). mu: the exact value rounded to
    the 1/16 grid (half a step, 1/32) plus the fixed-point band (the leaky
    ReLU floors each negative hidden value to 1/4096, so an output moves
    by at most the sum of its layer-2 weights' magnitudes over 4096) and
    1e-4 of f32 rounding; sigma: within one of the 256 log levels.
    Measured worst over these seeds: mu 0.03135 against a bound of
    0.0313 + band (band 0.0023-0.0034), sigma one level, in 0.07-0.33% of
    the values (near a level's edge)."""
    spec = M.build_model_spec(CH, entropy_mode="ctx_ar", ctx_hidden=32, ctx_tail=24)
    worst_mu = 0.0
    for seed in (1, 2, 3):
        payload = CTX.build_ctx_payload(spec, residuals(32, seed=seed, scale=0.1), 16)
        ints = CTX.ctx_ints_from_payload(spec, payload)
        y = latents(64, seed=seed + 10, spread=20).astype(np.int64)
        mu16, sidx = CTX.ExactPredictor(ints)(y)
        ref = R.CtxAR(CH, 32, 24)
        deq = {n: (torch.from_numpy(ints[f"K{i}"] / 4096.0).float(), torch.from_numpy(ints[f"b{i}"] / 4096.0).float())
               for i, n in enumerate(R.LAYERS, start=1)}
        mu_r, sigma_r = ref.predict(torch.from_numpy(y).float(), deq)
        band = np.abs(ints["K2"]).sum(axis=(0, 1, 2, 3))[:CH] / 4096.0 / 4096.0
        gap = np.abs(mu_r.numpy().astype(np.float64) - mu16 / 16.0)
        assert (gap <= 1 / 32 + band + 1e-4).all(), (gap.max(), band)
        level = np.clip(np.rint(16 * (np.log2(sigma_r.numpy().astype(np.float64)) + 6)), 0, 255)
        assert np.abs(level - sidx).max() <= 1
        worst_mu = max(worst_mu, float(gap.max()))
    assert worst_mu > 0.0  # the grid's rounding shows


def test_a_ctx_ar_pack_decodes_to_the_references_points():
    """At 24 blocks, flagship widths, hidden 32 tail 24: the port's pack
    decodes to the latents the encoder coded (one drawn latent lies beyond
    the alphabet, so the coded ones differ from the drawn), and its points
    are the reference's reconstruction of the coded latents at the pack's
    threshold; a voxel may differ only within 1e-5 of it (the same f32
    forward summed in another order). The drawn latents would not do."""
    n, depth, level = 24, 10, 5
    cfg = {"ch": CH, "chanstr": "8,16,8,8", "entropy_mode": "channel", "seed_tag": "nvfpcc-tpu/seed-stream/v1"}
    traffic = {"resid": {n_: [0.0, 0.06] for n_ in ("up0", "conv0", "up1", "conv1", "up2", "conv2", "conv2_cls")},
               "bias": {n_: [0.0, 0.2] for n_ in ("up0", "conv0", "up1", "conv1", "up2", "conv2", "conv2_cls")},
               "entropy_sigma": [1.0] * CH, "entropy_mu": [0.0] * CH}
    model = Model(cfg, "cpu")
    rng = np.random.default_rng(5)
    inits = {k: (v[0].numpy(), v[1].numpy()) for k, v in model.init.items()}
    flat = decode_params(rng, inits, cfg, traffic)
    flat = {k: v for k, v in flat.items() if not k.startswith("entropy/")}
    tree = unflatten_tree(flat)
    tree["entropy"] = residuals(32, seed=9, scale=0.05)
    drawn = latents(n, seed=4, spread=6)
    drawn[3, 1, 0, 1, 2] = 700.0  # beyond the alphabet: clamped in the coder
    origins = synthetic_origins(n, depth, level, 21)
    dec_p = {k: torch.from_numpy(v) for k, v in flat.items() if k.startswith("decoder/")}
    occ_drawn = reconstruct(model, dec_p, torch.from_numpy(drawn)).numpy()
    top = np.sort(occ_drawn.reshape(-1))[::-1]
    k = int(0.03 * top.size)
    thh = float(np.float32(0.5 * (top[k] + top[k + 1])))

    coded = []
    real = CTX.encode_latents_ctx

    def kept(*a, **kw):
        out = real(*a, **kw)
        coded.append(out)
        return out

    mcfg = ModelConfig(ch=CH, chanstr="8,16,8,8", entropy_mode="ctx_ar", ctx_hidden=32, ctx_tail=24)
    ccfg = CodecConfig(thh_encode=thh, qp=16, depth=depth, level=level, recon_dtype="f32")
    try:
        CTX.encode_latents_ctx = kept
        with pytest.warns(UserWarning, match="clamped"):
            res = codec.encode(tree, drawn, origins, mcfg, ccfg, 1000, "cpu")
    finally:
        CTX.encode_latents_ctx = real
    (enc,) = coded
    assert enc["n_clamped"] >= 1
    points, info = codec.decode(res.pack, "cpu")
    np.testing.assert_array_equal(points, res.points)
    spec = codec.model_spec(mcfg)
    np.testing.assert_array_equal(codec.decode_latent_pack(spec, res.pack["latent_pack"]), enc["coded"])
    occ = reconstruct(model, dec_p, torch.from_numpy(enc["coded"].astype(np.float32))).numpy()
    gap, _ = compare.point_gap(points, origins, occ, thh)
    assert gap <= 1e-5 and len(points) > 0
    assert compare.point_gap(points, origins, occ_drawn, thh)[0] > 1e-3
