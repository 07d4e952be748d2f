"""The port's context model (entropy modes ctx / ctx_ar, pack format v3)
against nvfpcc_tpu on the CPU, at the JAX suite's size (ch=2, chanstr
4,8,4,4): the masks of ctx, ctx_ar and ctx_ar with tail units, the feature
init, the predictor at q=0/1/2, the bottleneck's rate and ``net_apply``
with their embedding gradients against ``jax.grad`` (with and without
``ctx_detach_pred``), ctx packs crossing both ways with byte-equal payloads,
and the JAX-made ``pack_v3.pk``.

Tolerances (f32): predictor mu/sigma atol 2e-5 (values O(1-10)); per-block
latent bits rtol 1e-4; embedding gradients atol 2e-4 of the largest
magnitude; occupancy atol 1e-5; point sets across packages may differ only
at voxels whose occupancy lies within 1e-4 of ``thh``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvfpcc_tpu import codec as JC
from nvfpcc_tpu.codec import weights as JW
from nvfpcc_tpu.config import CodecConfig as JaxCodecConfig
from nvfpcc_tpu.config import ModelConfig as JaxModelConfig
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.octree.partition import leaf_origins
from nvfpcc_tpu.ops import conv as jconv
from nvfpcc_tpu_torch import codec as TC
from nvfpcc_tpu_torch.codec import weights as TW
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig
from nvfpcc_tpu_torch.models import decoder as TM
from nvfpcc_tpu_torch.ops import conv as tconv
from nvfpcc_tpu_torch.utils import checkpoint as TCK
from nvfpcc_tpu_torch.utils.params import params_from_numpy, params_to_numpy
from torch_train_helpers import noise_from_key, one_torch_thread  # noqa: F401  (autouse fixture)

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "packs")
CH, CHANNELS, CHANSTR = 2, (4, 8, 4, 4), "4,8,4,4"
# (mode, hidden, tail): plain ctx, ctx_ar, ctx_ar with tail units
SPECS = [("ctx", 8, 0), ("ctx_ar", 8, 0), ("ctx_ar", 8, 3)]
THH, BAND = 0.55, 1e-4


def _specs(mode, hidden, tail, detach=False):
    kw = dict(entropy_mode=mode, ctx_hidden=hidden, ctx_tail=tail, ctx_detach_pred=detach)
    return JM.build_model_spec(CH, CHANNELS, **kw), TM.build_model_spec(CH, CHANNELS, **kw)


def _ctx_tree(jspec, seed=0, scale=0.05, n_blocks=5):
    """A JAX params tree (numpy) with nonzero residuals everywhere, ctx
    kernels on the 1/16 grid with some spread, and embeddings."""
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(jspec))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, scale, a.shape)).astype(np.float32), tree)
    for n in JM.CTX_KERNELS:
        k = tree["entropy"][n]["kernel"]
        tree["entropy"][n]["kernel"] = (rng.integers(-6, 7, k.shape) / 16).astype(np.float32)
        tree["entropy"][n]["b"] = rng.normal(0, 0.3, k.shape[-1]).astype(np.float32)
    emb = rng.normal(0, 2, (n_blocks, 2, 2, 2, CH)).astype(np.float32)
    return tree, emb


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------- masks, inits


@pytest.mark.parametrize("mode,hidden,tail", SPECS)
def test_specs_masks_and_inits_equal(mode, hidden, tail):
    jspec, tspec = _specs(mode, hidden, tail)
    assert set(tspec.specs) == set(jspec.specs)
    for n in JM.CTX_KERNELS:
        js, ts = jspec.specs[n], tspec.specs[n]
        np.testing.assert_array_equal(ts.mask, js.mask)
        np.testing.assert_array_equal(ts.mask_flat_indices, js.mask_flat_indices)
        np.testing.assert_array_equal(ts.kernel_init, js.kernel_init)
        np.testing.assert_array_equal(ts.b_init, js.b_init)
        assert (ts.stride, ts.padding, ts.kernel_shape) == (js.stride, js.padding, js.kernel_shape)
    np.testing.assert_array_equal(tconv.causal_mask(3), jconv.causal_mask(3))
    assert (tspec.ctx_hidden, tspec.ctx_tail) == (hidden, tail)
    jf, tf = JM.ctx_feature_init(jspec), TM.ctx_feature_init(tspec)
    for n in JM.CTX_KERNELS:
        for leaf in ("kernel", "b"):
            np.testing.assert_array_equal(tf[n][leaf], np.asarray(jf[n][leaf]))
    # zero residuals at init, like the JAX package's
    got = params_to_numpy(TM.init_params(tspec))["entropy"]
    for n in JM.CTX_KERNELS:
        assert not got[n]["kernel"].any() and not got[n]["b"].any()


def test_spec_validation_and_counts():
    for kw, msg in ((dict(entropy_mode="ctx", ctx_tail=2), "needs entropy_mode=ctx_ar"),
                    (dict(entropy_mode="ctx_ar", ctx_hidden=8, ctx_tail=8), "ctx_tail must be")):
        with pytest.raises(ValueError, match=msg):
            TM.build_model_spec(CH, CHANNELS, **kw)
    assert TM._LAYER_SEED_IDX == JM._LAYER_SEED_IDX
    assert (TM.CTX_KERNELS, TM.CTX_MODES, TM.CTX_HIDDEN, TM.CTX_LRELU_SLOPE, TM.CTX_SIGMA_FLOOR) == (
        JM.CTX_KERNELS, JM.CTX_MODES, JM.CTX_HIDDEN, JM.CTX_LRELU_SLOPE, JM.CTX_SIGMA_FLOOR)
    for mode, hidden, tail in SPECS:
        jspec, tspec = _specs(mode, hidden, tail)
        assert TM.count_transmitted_residuals(tspec) == JM.count_transmitted_residuals(jspec)


# ------------------------------------------------------- predictor and rate


@pytest.mark.parametrize("mode,hidden,tail", SPECS)
def test_predictor_at_each_phase(mode, hidden, tail):
    jspec, tspec = _specs(mode, hidden, tail)
    tree, _ = _ctx_tree(jspec)
    pred = params_from_numpy(TM.CtxPredictor(tspec), tree["entropy"])
    x = np.rint(np.random.default_rng(1).normal(0, 3, (6, 2, 2, 2, CH))).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    noise = {"ctx1": torch.as_tensor(np.array(jax.random.uniform(
                 k1, tspec.specs["ctx1"].kernel_shape, jnp.float32, -0.5, 0.5))),
             "ctx2": torch.as_tensor(np.array(jax.random.uniform(
                 k2, tspec.specs["ctx2"].kernel_shape, jnp.float32, -0.5, 0.5)))}
    for q in (0, 1, 2):
        jmu, jsig = JM.ctx_pred_apply(jspec, _jtree(tree), jnp.asarray(x), q, key if q == 1 else None)
        with torch.no_grad():
            tmu, tsig = pred(torch.as_tensor(x), q, noise if q == 1 else None)
        np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), rtol=0, atol=2e-5, err_msg=f"q={q}")
        np.testing.assert_allclose(tsig.numpy(), np.asarray(jsig), rtol=0, atol=2e-5, err_msg=f"q={q}")
    with pytest.raises(ValueError, match="noise"):
        pred(torch.as_tensor(x), 1)


def _grad_pair(jspec, tspec, tree, emb, fn_j, fn_t):
    """(JAX value, JAX d/d emb, port value, port d/d emb) of scalar functions."""
    jv, jg = jax.value_and_grad(fn_j)(jnp.asarray(emb))
    net = params_from_numpy(TM.init_params(tspec), tree)
    e = torch.as_tensor(emb).requires_grad_(True)
    tv = fn_t(net, e)
    (tg,) = torch.autograd.grad(tv, e)
    return float(jv), np.asarray(jg), float(tv.detach()), tg.numpy()


@pytest.mark.parametrize("detach", [False, True])
@pytest.mark.parametrize("q", [1, 2])
def test_entropy_apply_rate_and_emb_grad(q, detach):
    """ctx_ar with tail units: the rate and its embedding gradient, at train
    q=1 (noise replayed) and q=2 (no noise: the rate is formed on the
    rounded latents), with the predictor's input detached or not."""
    jspec, tspec = _specs("ctx_ar", 8, 3, detach)
    tree, emb = _ctx_tree(jspec)
    key = jax.random.PRNGKey(5)
    nz = noise_from_key(jax.random.fold_in(key, 0), emb.shape, q, jspec)
    ekey = jax.random.split(jax.random.fold_in(key, 0))[0]
    assert ("latent" in nz) == (q == 1)

    def fj(e):
        lat = JM.latent_gen_apply(jspec, _jtree(tree), e)
        _, bits = JM.entropy_apply(jspec, _jtree(tree), lat, "train", ekey, q)
        return bits.sum()

    def ft(net, e):
        _, bits = TM.entropy_apply(net, net.latent_gen(e), "train", nz.get("latent"), q, nz)
        return bits.sum()

    jv, jg, tv, tg = _grad_pair(jspec, tspec, tree, emb, fj, ft)
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(tg, jg, rtol=0, atol=2e-4 * np.abs(jg).max())


def test_net_apply_values_and_emb_grad():
    """ctx_ar with tail units, the whole train-mode forward at q=1 with the
    JAX draws replayed: the occupancy, the 9 network-bit entries (7 decoder
    + 2 ctx kernels), the per-block latent bits, and the gradient of the
    summed rate + occupancy."""
    jspec, tspec = _specs("ctx_ar", 8, 3)
    tree, emb = _ctx_tree(jspec)
    key = jax.random.PRNGKey(9)
    nz = noise_from_key(key, emb.shape, 1, jspec)
    jout = JM.net_apply(jspec, _jtree(tree), jnp.asarray(emb), "train", 1, key)
    net = params_from_numpy(TM.init_params(tspec), tree)
    with torch.no_grad():
        tout = TM.net_apply(net, torch.as_tensor(emb), "train", 1, nz)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=0, atol=1e-5)
    assert tout[2].shape == (9,)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=1e-4)
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]), rtol=1e-4)

    def fj(e):
        occ, _, nb, lb = JM.net_apply(jspec, _jtree(tree), e, "train", 1, key)
        return lb.sum() + nb.sum() + 100.0 * occ.mean()

    def ft(n, e):
        occ, _, nb, lb = TM.net_apply(n, e, "train", 1, nz)
        return lb.sum() + nb.sum() + 100.0 * occ.mean()

    jv, jg, tv, tg = _grad_pair(jspec, tspec, tree, emb, fj, ft)
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
    np.testing.assert_allclose(tg, jg, rtol=0, atol=2e-4 * np.abs(jg).max())


def test_latent_code_and_network_bits():
    jspec, tspec = _specs("ctx_ar", 8, 3)
    tree, emb = _ctx_tree(jspec)
    net = params_from_numpy(TM.init_params(tspec), tree)
    jcode = JM.get_latent_code(jspec, _jtree(tree), jnp.asarray(emb))
    with torch.no_grad():
        tcode = TM.get_latent_code(net, torch.as_tensor(emb))
        tbits = TM.get_network_bits(net)
    assert set(tcode) == set(jcode) == {"quantized_latent", "latent_bits"}
    np.testing.assert_array_equal(tcode["quantized_latent"].numpy(), np.asarray(jcode["quantized_latent"]))
    np.testing.assert_allclose(float(tcode["latent_bits"]), float(jcode["latent_bits"]), rtol=1e-4)
    want = JM.get_network_bits(jspec, _jtree(tree))
    assert abs(tbits - want) <= 1e-4 * abs(want)


# ------------------------------------------------------------------- packs


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    """One ctx_ar-with-tail params tree encoded by both packages."""
    jspec, _ = _specs("ctx_ar", 8, 3)
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 2 * np.pi, 1500)
    pts = np.unique(np.clip(np.rint(np.stack(
        [64 + 38 * np.cos(t), 64 + 38 * np.sin(t), 64 + 19 * np.sin(2 * t)], -1)), 0, 127).astype(np.int64), axis=0)
    origins = leaf_origins(pts, 7, 2)
    tree, emb = _ctx_tree(jspec, seed=2, scale=0.03, n_blocks=len(origins))
    for n in JM.TRANSMITTED_KERNELS:
        k = tree["decoder"][n]["kernel"]
        tree["decoder"][n]["kernel"] = (k + rng.integers(-2, 3, k.shape) / 16).astype(np.float32)
    emb = (emb * 3).astype(np.float32)
    kw = dict(ch=CH, chanstr=CHANSTR, entropy_mode="ctx_ar", ctx_hidden=8, ctx_tail=3)
    ckw = dict(thh_encode=THH, thh_decode=THH, depth=7, level=2)
    t_res = TC.encode(tree, emb, origins, ModelConfig(**kw), CodecConfig(**ckw), len(pts), "cpu")
    j_res = JC.encode(tree, emb, origins, JaxModelConfig(**kw), JaxCodecConfig(**ckw), len(pts))
    assert len(t_res.points) > 0
    return {"tree": tree, "emb": emb, "origins": origins, "t": t_res, "j": j_res,
            "dir": tmp_path_factory.mktemp("ctxpacks")}


def _assert_only_band_differs(a, b, pack):
    """Points in one set and not the other lie in the thh band of the
    port's occupancy field for this pack."""
    diff = set(map(tuple, a)) ^ set(map(tuple, b))
    if not diff:
        return
    mc = pack["model"]
    spec = TC.model_spec(ModelConfig(
        ch=mc["ch"], chanstr=mc["chanstr"], entropy_mode=mc["entropy_mode"],
        ctx_hidden=mc.get("ctx_hidden", 8), ctx_tail=mc.get("ctx_tail", 0)))
    occ = TC.reconstruct_all(
        TC.decoder_from_tree(spec, TW.unpack_weights(pack["net_weight_pack"]), "cpu"),
        TC.decode_latent_pack(spec, pack["latent_pack"]),
    )
    origins = TC.decode_origins(pack["origins"], int(pack["codec"]["depth"]), int(pack["codec"]["level"]))
    block_of = {tuple(o): i for i, o in enumerate(origins)}
    bsz, thh = occ.shape[1], float(pack["codec"]["thh"])
    for p in diff:
        o = tuple((np.asarray(p) // bsz) * bsz)
        v = np.asarray(p) - np.asarray(o)
        assert abs(occ[block_of[o], v[0], v[1], v[2]] - thh) < BAND, p


def test_ctx_packs_carry_the_same_bytes(packs):
    tp, jp = packs["t"].pack, packs["j"].pack
    assert tp["model"] == jp["model"] and tp["model"]["ctx_tail"] == 3 and tp["model"]["ctx_hidden"] == 8
    assert tp["codec"] == jp["codec"] and tp["origins"] == jp["origins"]
    assert tp["net_weight_pack"]["bit_stream"] == jp["net_weight_pack"]["bit_stream"]
    tl, jl = tp["latent_pack"], jp["latent_pack"]
    assert tl["mode"] == jl["mode"] == "ctx_ar" and tl["shape"] == jl["shape"]
    assert tl["stream"] == jl["stream"]
    tc, jc = tl["ctx"], jl["ctx"]
    assert tc["qp"] == jc["qp"] and tc["res"]["bit_stream"] == jc["res"]["bit_stream"]
    assert tc["res"]["min_sym"] == jc["res"]["min_sym"] and tc["res"]["element_length"] == jc["res"]["element_length"]
    np.testing.assert_array_equal(tc["res"]["counts"], jc["res"]["counts"])
    for n in JM.CTX_KERNELS:
        np.testing.assert_array_equal(tc["bias"][n], jc["bias"][n])
        assert tc["bias"][n].dtype == jc["bias"][n].dtype
    # the ctx payload is network weight in both packages' stats
    for k in ("b_net", "b_latent", "b_origins", "bpp", "latent_stream_bytes"):
        assert packs["t"].stats[k] == pytest.approx(packs["j"].stats[k], rel=1e-12), k
    assert packs["t"].stats["ctx_payload_bits"] > 0
    # quantize_residuals rounds the ctx kernels as the JAX package does
    tq, jq = TW.quantize_residuals(packs["tree"], 16), JW.quantize_residuals(packs["tree"], 16)
    for n in JM.CTX_KERNELS:
        np.testing.assert_array_equal(tq["entropy"][n]["kernel"], np.asarray(jq["entropy"][n]["kernel"]))


def test_ctx_pack_decodes_in_the_port_and_crosses_both_ways(packs):
    path = str(packs["dir"] / "pack.pk")
    TC.save_pack(path, packs["t"].pack)
    points, info = TC.decode(TC.load_pack(path), "cpu")
    np.testing.assert_array_equal(points, packs["t"].points)  # rc_enc == rc_dec
    assert info["n_blocks"] == len(packs["origins"])
    jpoints, _ = JC.decode(packs["t"].pack)
    _assert_only_band_differs(packs["t"].points, jpoints, packs["t"].pack)
    tpoints, _ = TC.decode(packs["j"].pack, "cpu")
    _assert_only_band_differs(tpoints, packs["j"].points, packs["j"].pack)


def test_ctx_checkpoints_cross_both_ways(packs, tmp_path):
    """A port ctx checkpoint loads in the JAX package with its ctx metadata,
    and a JAX one loads here, every leaf equal."""
    from nvfpcc_tpu.utils import checkpoint as JCK

    meta = {"ch": CH, "chanstr": CHANSTR, "entropy_mode": "ctx_ar", "ctx_hidden": 8, "ctx_tail": 3}
    tpath = TCK.save_checkpoint(str(tmp_path / "t"), 4, packs["tree"], packs["emb"], meta=meta)
    jparams, jemb, jmeta = JCK.load_checkpoint_meta(tpath)
    assert jmeta == meta
    jpath = JCK.save_checkpoint(str(tmp_path / "j"), 4, jparams, jemb, meta=meta)
    tparams, temb, tmeta = TCK.load_checkpoint_meta(jpath)
    assert tmeta == meta
    np.testing.assert_array_equal(temb, packs["emb"])
    _, tspec = _specs("ctx_ar", 8, 3)
    net = params_from_numpy(TM.init_params(tspec), tparams)  # strict: every leaf named
    for n in JM.CTX_KERNELS:
        for leaf in ("kernel", "b"):
            np.testing.assert_array_equal(params_to_numpy(net)["entropy"][n][leaf], packs["tree"]["entropy"][n][leaf])


def test_pack_v3_fixture_decodes():
    """The JAX-made ctx pack: latents equal to the golden ints exactly,
    points equal to a reconstruction from the golden arrays and to the JAX
    decode within the thh band."""
    pack = TC.load_pack(os.path.join(FIXDIR, "pack_v3.pk"))
    golden = np.load(os.path.join(FIXDIR, "golden_v3.npz"))
    assert pack["format_version"] == 3 and pack["latent_pack"]["mode"] == "ctx"
    spec = TC.model_spec(ModelConfig(ch=2, chanstr=CHANSTR, entropy_mode="ctx"))
    lat = TC.decode_latent_pack(spec, pack["latent_pack"])
    np.testing.assert_array_equal(lat, golden["latents"].astype(np.float32))
    points, info = TC.decode(pack, "cpu")
    assert info["n_blocks"] == len(golden["origins"]) and len(points) > 0
    tree = TW.unpack_weights(pack["net_weight_pack"])
    for name in TM.TRANSMITTED_KERNELS:
        np.testing.assert_array_equal(tree["decoder"][name]["kernel"], golden[f"kernel_{name}"])
    live = TC.reconstruct_points(TC.decoder_from_tree(spec, tree, "cpu"), lat, golden["origins"],
                                 float(pack["codec"]["thh"]))
    np.testing.assert_array_equal(points, live)
    jpoints, _ = JC.decode(pack)
    _assert_only_band_differs(points, jpoints, pack)
