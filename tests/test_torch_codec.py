"""The port's codec against nvfpcc_tpu.codec: encode == decode bit-exact
inside the port, packs crossing both ways, the JAX-made v1 fixture, JAX
checkpoints encoding in the port, and cross-package point sets that differ
only at voxels whose occupancy lies within 1e-4 of ``thh``."""

import os

import jax
import numpy as np
import pytest

from nvfpcc_tpu import codec as JC
from nvfpcc_tpu.codec import weights as JW
from nvfpcc_tpu.config import CodecConfig, ModelConfig
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.octree.partition import leaf_origins
from nvfpcc_tpu.utils import checkpoint as JCK
from nvfpcc_tpu_torch import codec as TC
from nvfpcc_tpu_torch.codec import weights as TW
from nvfpcc_tpu_torch.config import ModelConfig as CodecModelConfig
from nvfpcc_tpu_torch.models import decoder as TM
from nvfpcc_tpu_torch.utils import checkpoint as TCK
from torch_train_helpers import assert_only_band_differs

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures", "packs")
THH = 0.55
BAND = 1e-4
MCFG = ModelConfig(ch=2, chanstr="4,8,4,4", entropy_mode="channel")
CCFG = CodecConfig(thh_encode=THH, thh_decode=THH, depth=7, level=2)


def _toy_cloud(n=1500, size=128, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    pts = np.stack(
        [size / 2 + size * 0.3 * np.cos(t), size / 2 + size * 0.3 * np.sin(t),
         size / 2 + size * 0.15 * np.sin(2 * t)], axis=-1,
    )
    return np.unique(np.clip(np.rint(pts), 0, size - 1).astype(np.int64), axis=0)


@pytest.fixture(scope="module")
def setup():
    """A JAX params tree with off-grid residuals everywhere, embeddings, origins."""
    pts = _toy_cloud()
    origins = leaf_origins(pts, 7, 2)
    spec = JM.build_model_spec(2, (4, 8, 4, 4))
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(spec))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.03, a.shape)).astype(np.float32), tree)
    for name in JM.TRANSMITTED_KERNELS:
        k = tree["decoder"][name]["kernel"]
        tree["decoder"][name]["kernel"] = (k + rng.integers(-2, 3, k.shape) / 16).astype(np.float32)
    tree["entropy"]["sigma"] = rng.uniform(1.0, 3.0, 2).astype(np.float32)
    emb = rng.normal(0, 2, (len(origins), 2, 2, 2, 2)).astype(np.float32)
    t_res = TC.encode(tree, emb, origins, MCFG, CCFG, len(pts), "cpu")
    j_res = JC.encode(tree, emb, origins, MCFG, CCFG, len(pts))
    assert len(t_res.points) > 0
    return {"pts": pts, "origins": origins, "tree": tree, "emb": emb, "t": t_res, "j": j_res}


def test_torch_encode_equals_torch_decode(setup, tmp_path):
    path = str(tmp_path / "pack.pk")
    TC.save_pack(path, setup["t"].pack)
    points, info = TC.decode(TC.load_pack(path), "cpu")
    np.testing.assert_array_equal(points, setup["t"].points)
    assert info["n_blocks"] == len(setup["origins"])
    s = setup["t"].stats
    assert abs(s["bpp"] - (s["b_net"] + s["b_latent"] + s["b_origins"])) < 1e-9


@pytest.mark.parametrize("entropy", ["range_pl", "range", "huffman", "auto", "gaussian"])
def test_weight_pack_is_the_jax_bytes(setup, entropy):
    tq = TW.quantize_residuals(setup["tree"], 16)
    jq = JW.quantize_residuals(setup["tree"], 16)
    for name in TM.TRANSMITTED_KERNELS:
        np.testing.assert_array_equal(tq["decoder"][name]["kernel"], np.asarray(jq["decoder"][name]["kernel"]))
    tp, jp = TW.pack_weights(tq, 16, entropy), JW.pack_weights(jq, 16, entropy)
    assert tp["mode"] == jp["mode"] and tp["bit_stream"] == jp["bit_stream"]
    assert TW.weight_pack_bits(tp) == JW.weight_pack_bits(jp)
    back = TW.unpack_weights(jp)["decoder"]
    jback = JW.unpack_weights(tp)["decoder"]  # and the JAX package decodes the port's pack
    for name in TM.TRANSMITTED_KERNELS:
        np.testing.assert_array_equal(back[name]["kernel"], tq["decoder"][name]["kernel"])
        np.testing.assert_array_equal(back[name]["b"], tq["decoder"][name]["b"])
        np.testing.assert_array_equal(np.asarray(jback[name]["kernel"]), tq["decoder"][name]["kernel"])
    if entropy == "gaussian":
        for k in ("min_sym", "max_sym", "wrate_sigma", "wrate_mu"):
            assert tp[k] == jp[k] and type(tp[k]) is type(jp[k])
        no_wrate = {"decoder": {k: v for k, v in tq["decoder"].items() if k != "wrate"}}
        with pytest.raises(ValueError, match="wrate"):
            TW.pack_weights(no_wrate, 16, "gaussian")


def test_packs_carry_the_same_payloads(setup):
    tp, jp = setup["t"].pack, setup["j"].pack
    assert tp["model"] == jp["model"] and tp["codec"] == jp["codec"]
    assert tp["format_version"] == jp["format_version"] == 4
    assert tp["net_weight_pack"]["bit_stream"] == jp["net_weight_pack"]["bit_stream"]
    assert tp["origins"] == jp["origins"]
    assert tp["latent_pack"]["stream"] == jp["latent_pack"]["stream"]


def test_torch_pack_decodes_in_jax(setup):
    jpoints, _ = JC.decode(setup["t"].pack)
    assert_only_band_differs(setup["t"].points, jpoints, setup["t"].pack, BAND)


def test_jax_pack_decodes_in_torch(setup):
    tpoints, _ = TC.decode(setup["j"].pack, "cpu")
    assert_only_band_differs(tpoints, setup["j"].points, setup["j"].pack, BAND)


def test_pack_v1_fixture_decodes_in_torch():
    pack = TC.load_pack(os.path.join(FIXDIR, "pack_v1.pk"))
    golden = np.load(os.path.join(FIXDIR, "golden_v1.npz"))
    points, info = TC.decode(pack, "cpu")
    assert info["n_blocks"] == len(golden["origins"]) and len(points) > 0
    spec = TM.build_model_spec(2, (4, 8, 4, 4))
    tree = TW.unpack_weights(pack["net_weight_pack"])
    for name in TM.TRANSMITTED_KERNELS:
        np.testing.assert_array_equal(tree["decoder"][name]["kernel"], golden[f"kernel_{name}"])
    live = TC.reconstruct_points(
        TC.decoder_from_tree(spec, tree, "cpu"), golden["latents"].astype(np.float32),
        golden["origins"], float(pack["codec"]["thh"]),
    )
    np.testing.assert_array_equal(points, live)
    jpoints, _ = JC.decode(pack)
    assert_only_band_differs(points, jpoints, pack, BAND)


def test_jax_checkpoint_encodes_in_torch(setup, tmp_path):
    path = JCK.save_checkpoint(str(tmp_path), 7, setup["tree"], setup["emb"], meta={"ch": 2})
    assert TCK.latest_checkpoint(str(tmp_path)) == path
    params, emb, meta = TCK.load_checkpoint_meta(path)
    assert meta == {"ch": 2}
    res = TC.encode(params, emb, setup["origins"], MCFG, CCFG, len(setup["pts"]), "cpu")
    np.testing.assert_array_equal(res.points, setup["t"].points)
    assert res.pack["latent_pack"]["stream"] == setup["t"].pack["latent_pack"]["stream"]
    # and a port checkpoint loads in the JAX package
    tpath = TCK.save_checkpoint(str(tmp_path / "t"), 3, params, emb, meta=meta)
    jparams, jemb, jmeta = JCK.load_checkpoint_meta(tpath)
    np.testing.assert_array_equal(jemb, emb)
    np.testing.assert_array_equal(jparams["decoder"]["up0"]["kernel"], params["decoder"]["up0"]["kernel"])


def test_refusals(setup, tmp_path):
    pack = dict(setup["t"].pack)
    with pytest.raises(ValueError, match="unsupported pack format"):
        TC.decode({**pack, "format_version": 99}, "cpu")
    # bf16 packs decode since the bf16 reconstruction was ported; a dtype
    # neither package knows is refused, as the JAX package refuses it
    with pytest.raises(ValueError, match="unsupported recon_dtype"):
        TC.decode({**pack, "codec": {**pack["codec"], "recon_dtype": "fp16"}}, "cpu")
    import pickle

    bad = str(tmp_path / "bad.pk")
    with open(bad, "wb") as f:
        pickle.dump({"x": os.system}, f)
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        TC.load_pack(bad)


@pytest.mark.parametrize("version,item", [(2, "A12"), (3, "A13")])
def test_unported_mode_fixtures_refuse_clearly(version, item):
    """The name predates the port of both modes: pack_v2 (spatio, Huffman
    weights; A12) and pack_v3 (ctx; A13) decode. Their latents equal the
    golden ints exactly; pack_v2's points equal the JAX decode within the
    thh band (tests/test_torch_ctx.py checks pack_v3's points)."""
    pack = TC.load_pack(os.path.join(FIXDIR, f"pack_v{version}.pk"))
    golden = np.load(os.path.join(FIXDIR, f"golden_v{version}.npz"))
    mode = "spatio" if item == "A12" else "ctx"
    assert pack["model"]["entropy_mode"] == mode
    spec = TC.model_spec(CodecModelConfig(ch=2, chanstr="4,8,4,4", entropy_mode=mode))
    np.testing.assert_array_equal(TC.decode_latent_pack(spec, pack["latent_pack"]), golden["latents"])
    points, info = TC.decode(pack, "cpu")
    assert info["n_blocks"] == len(golden["origins"]) and len(points) > 0
    if mode == "spatio":
        assert pack["latent_pack"]["sigma"].shape == (2, 2, 2, 2)
        assert_only_band_differs(points, JC.decode(pack)[0], pack, BAND)
