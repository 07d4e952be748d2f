"""Latent packs of the spatio, gmm and factorized entropy modes, the port
against nvfpcc_tpu.codec on the CPU (ch=2, chanstr 4,8,4,4, a toy cloud at
depth 7, level 2): from the same params both packages write the same latent
stream and the same table params; the port's encode equals its decode bit
for bit; packs cross both ways, with point sets that differ only at voxels
whose occupancy lies within 1e-4 of ``thh``. (The JAX-made spatio fixture
``pack_v2.pk`` is decoded in tests/test_torch_codec.py.)"""

import jax
import numpy as np
import pytest

from torch_train_helpers import assert_only_band_differs, one_torch_thread  # noqa: F401  (autouse fixture)
from nvfpcc_tpu import codec as JC
from nvfpcc_tpu.config import CodecConfig as JaxCodecConfig
from nvfpcc_tpu.config import ModelConfig as JaxModelConfig
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.octree.partition import leaf_origins
from nvfpcc_tpu_torch import codec as TC
from nvfpcc_tpu_torch.config import CodecConfig, ModelConfig
from test_torch_codec import _toy_cloud

THH, BAND = 0.55, 1e-4


@pytest.fixture(scope="module", params=["spatio", "gmm", "factorized"])
def packs(request):
    """The same trained-like params tree encoded by both packages."""
    mode = request.param
    pts = _toy_cloud()
    origins = leaf_origins(pts, 7, 2)
    jspec = JM.build_model_spec(2, (4, 8, 4, 4), entropy_mode=mode)
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.03, np.shape(a))).astype(np.float32), JM.init_params(jspec))
    for name in JM.TRANSMITTED_KERNELS:
        k = tree["decoder"][name]["kernel"]
        tree["decoder"][name]["kernel"] = (k + rng.integers(-2, 3, k.shape) / 16).astype(np.float32)
    emb = rng.normal(0, 2, (len(origins), 2, 2, 2, 2)).astype(np.float32)
    kw = dict(ch=2, chanstr="4,8,4,4", entropy_mode=mode)
    t_res = TC.encode(tree, emb, origins, ModelConfig(**kw),
                      CodecConfig(thh_encode=THH, thh_decode=THH, depth=7, level=2), len(pts), "cpu")
    j_res = JC.encode(tree, emb, origins, JaxModelConfig(**kw),
                      JaxCodecConfig(thh_encode=THH, thh_decode=THH, depth=7, level=2), len(pts))
    assert len(t_res.points) > 0
    return {"mode": mode, "t": t_res, "j": j_res}


def test_mode_packs_carry_the_same_latent_stream(packs):
    tp, jp = packs["t"].pack, packs["j"].pack
    assert tp["model"] == jp["model"] and tp["codec"] == jp["codec"]
    tl, jl = tp["latent_pack"], jp["latent_pack"]
    assert set(tl) == set(jl) and tl["stream"] == jl["stream"] and tuple(tl["shape"]) == tuple(jl["shape"])
    if packs["mode"] == "spatio":
        assert tl["sigma"].shape == (2, 2, 2, 2)
        for k in ("sigma", "mu"):
            np.testing.assert_array_equal(tl[k], jl[k])
    else:
        assert tl["mode"] == packs["mode"] and list(tl["params"]) == list(jl["params"])
        for k, v in jl["params"].items():
            assert tl["params"][k].dtype == np.float32
            np.testing.assert_array_equal(tl["params"][k], v)
    assert tp["net_weight_pack"]["bit_stream"] == jp["net_weight_pack"]["bit_stream"]
    for k in ("b_latent", "b_net", "bpp"):
        assert packs["t"].stats[k] == pytest.approx(packs["j"].stats[k], rel=1e-12)
    assert packs["t"].stats["latent_table_bits"] > 0


def test_mode_packs_decode_in_both_packages(packs):
    """The port's encode equals its decode exactly; the JAX pack decodes in
    the port to the port's own points (same weights, same latents); the
    port's pack decodes in JAX within the thh band."""
    t_res, j_res = packs["t"], packs["j"]
    points, info = TC.decode(t_res.pack, "cpu")
    np.testing.assert_array_equal(points, t_res.points)
    assert info["recon_dtype"] == "f32"
    from_jax, _ = TC.decode(j_res.pack, "cpu")
    np.testing.assert_array_equal(from_jax, t_res.points)
    jpoints, _ = JC.decode(t_res.pack)
    assert_only_band_differs(t_res.points, jpoints, t_res.pack, BAND)
    assert_only_band_differs(from_jax, j_res.points, j_res.pack, BAND)
