"""bf16 reconstruction packs (``codec.recon_dtype: "bf16"``), the port
against nvfpcc_tpu.codec on the CPU (ch=2, chanstr 4,8,4,4, a toy cloud at
depth 7, level 2).

The port's bf16 program is the JAX package's as written: residuals, seeded
inits, IGDN params and latents cast to bf16, every op rounded to bf16 (the
bias added after the rounded conv result), then an exact upcast to f32
before the threshold. XLA on the CPU keeps excess precision inside its
fusions (its bf16 output is not even bf16-representable), and accumulates
convs in another order, so the two packages' bf16 occupancies differ: the
stated band is 8 bf16 ulps of the occupancy value (measured here at most
2.3, with 95.5% of voxels off by under one ulp; 5.4 on another tree), and
across packages point sets may differ only at voxels within 8 ulps of
``thh`` (2^-5 at 0.55; measured: 422 of the port's 219,866 points, 0.19%;
the port's own f32 and bf16 packs differ at 852 voxels). Inside the port
``rc_enc == rc_dec`` is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_helpers import assert_only_band_differs, one_torch_thread  # noqa: F401  (autouse fixture)
from nvfpcc_tpu import codec as JC
from nvfpcc_tpu.codec.codec import _recon_fn
from nvfpcc_tpu.config import CodecConfig as JaxCodecConfig
from nvfpcc_tpu.config import ModelConfig as JaxModelConfig
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.octree.partition import leaf_origins
from nvfpcc_tpu_torch import codec as TC
from nvfpcc_tpu_torch.codec import weights as TW
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig
from nvfpcc_tpu_torch.models import decoder as TM
from test_torch_codec import _toy_cloud

THH = 0.55
ULPS = 8
BAND = ULPS * 2.0 ** -8  # bf16 ulp on [0.5, 1)
KW = dict(ch=2, chanstr="4,8,4,4", entropy_mode="channel")


def _ccfg(cls, recon_dtype):
    return cls(thh_encode=THH, thh_decode=THH, depth=7, level=2, recon_dtype=recon_dtype)


@pytest.fixture(scope="module")
def setup():
    pts = _toy_cloud()
    origins = leaf_origins(pts, 7, 2)
    spec = JM.build_model_spec(2, (4, 8, 4, 4))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.03, np.shape(a))).astype(np.float32), JM.init_params(spec))
    for name in JM.TRANSMITTED_KERNELS:
        k = tree["decoder"][name]["kernel"]
        tree["decoder"][name]["kernel"] = (np.rint(k * 16) / 16 + rng.integers(-2, 3, k.shape) / 16).astype(np.float32)
    emb = rng.normal(0, 2, (len(origins), 2, 2, 2, 2)).astype(np.float32)
    res = {r: TC.encode(tree, emb, origins, ModelConfig(**KW), _ccfg(CodecConfig, r), len(pts), "cpu")
           for r in ("f32", "bf16")}
    j_res = JC.encode(tree, emb, origins, JaxModelConfig(**KW), _ccfg(JaxCodecConfig, "bf16"), len(pts))
    assert len(res["bf16"].points) > 0
    return {"pts": pts, "origins": origins, "tree": tree, "spec": spec, "t": res, "j": j_res}


def _ulps(v):
    """One bf16 ulp at each value's binade (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def test_bf16_occupancy_within_the_band_of_jax(setup):
    """The port's bf16 decode of a fixed tree against JAX's
    ``_recon_fn(spec, "bf16")``; both upcast to f32."""
    tree = TW.unpack_weights(setup["t"]["bf16"].pack["net_weight_pack"])
    lat = np.rint(np.random.default_rng(1).normal(0, 3, (20, 2, 2, 2, 2))).astype(np.float32)
    want = np.asarray(_recon_fn(setup["spec"], "bf16")(jax.tree_util.tree_map(jnp.asarray, tree),
                                                         jnp.asarray(lat)))[..., 0]
    dec = TC.decoder_from_tree(TM.build_model_spec(2, (4, 8, 4, 4)), tree, "cpu", "bf16")
    assert dec.up0.kernel.dtype == dec.up0.kernel_init.dtype == dec.igdn.gamma.dtype == torch.bfloat16
    got = TC.reconstruct_all(dec, lat)
    assert got.dtype == np.float32 and want.dtype == np.float32
    # every port value is a bf16 value, exactly upcast
    np.testing.assert_array_equal(torch.from_numpy(got).bfloat16().float().numpy(), got)
    ulps = np.abs(got - want) / _ulps(want)
    assert ulps.max() <= ULPS, ulps.max()
    assert (ulps < 1).mean() > 0.9
    # and bf16 is a different program from f32: it moves the occupancy
    f32 = TC.reconstruct_all(TC.decoder_from_tree(TM.build_model_spec(2, (4, 8, 4, 4)), tree, "cpu"), lat)
    assert np.abs(got - f32).max() > 2.0 ** -9


def test_bf16_encode_equals_decode_and_crosses_both_ways(setup):
    t16, j16 = setup["t"]["bf16"], setup["j"]
    points, info = TC.decode(t16.pack, "cpu")
    np.testing.assert_array_equal(points, t16.points)  # rc_enc == rc_dec
    assert info["recon_dtype"] == "bf16"
    assert t16.pack["latent_pack"]["stream"] == j16.pack["latent_pack"]["stream"]
    assert t16.pack["net_weight_pack"]["bit_stream"] == j16.pack["net_weight_pack"]["bit_stream"]
    from_jax, _ = TC.decode(j16.pack, "cpu")
    np.testing.assert_array_equal(from_jax, t16.points)
    jpoints, jinfo = JC.decode(t16.pack)
    assert jinfo["recon_dtype"] == "bf16"
    assert_only_band_differs(t16.points, jpoints, t16.pack, BAND)
    assert_only_band_differs(from_jax, j16.points, j16.pack, BAND)
    # f32 and bf16 packs of one checkpoint reconstruct different clouds
    assert not np.array_equal(setup["t"]["f32"].points, t16.points)


def test_pack_layout_equals_jax(setup):
    """``codec.recon_dtype`` is written only for bf16; everything else in the
    codec block is the JAX package's."""
    t32, t16, j16 = setup["t"]["f32"].pack, setup["t"]["bf16"].pack, setup["j"].pack
    assert "recon_dtype" not in t32["codec"]
    assert t16["codec"] == j16["codec"] and t16["codec"]["recon_dtype"] == "bf16"
    assert {k: v for k, v in t16["codec"].items() if k != "recon_dtype"} == t32["codec"]
    assert t16["model"] == j16["model"]


def test_threshold_is_compared_after_the_upcast(setup):
    """A ``thh`` that is not a bf16 value, a quarter ulp under an occupancy
    value the bf16 decode produces: a bf16 compare would round ``thh`` up to
    that value and drop its voxels; the port keeps them."""
    tree = TW.unpack_weights(setup["t"]["bf16"].pack["net_weight_pack"])
    dec = TC.decoder_from_tree(TM.build_model_spec(2, (4, 8, 4, 4)), tree, "cpu", "bf16")
    lat = TC.decode_latent_pack(TM.build_model_spec(2, (4, 8, 4, 4)), setup["t"]["bf16"].pack["latent_pack"])
    occ = TC.reconstruct_all(dec, lat)
    vals, counts = np.unique(occ[(occ > 0.5) & (occ < 1.0)], return_counts=True)
    v = float(vals[np.argmax(counts)])
    thh = v - 2.0 ** -10
    assert float(torch.tensor(thh).bfloat16()) == v  # thh rounds to v in bf16
    points = TC.reconstruct_points(dec, lat, setup["origins"], thh)
    np.testing.assert_array_equal(points, TC.extract_points(occ, setup["origins"], thh))
    bf16_compare = int((torch.from_numpy(occ).bfloat16() > thh).sum())
    assert len(points) == bf16_compare + int((occ == v).sum()) and (occ == v).sum() > 0


def test_unknown_recon_dtype_raises(setup):
    with pytest.raises(ValueError, match="unsupported recon_dtype"):
        TC.encode(setup["tree"], np.ones((len(setup["origins"]), 2, 2, 2, 2), np.float32), setup["origins"],
                  ModelConfig(**KW), _ccfg(CodecConfig, "fp16"), len(setup["pts"]), "cpu")
