"""nvfpcc_tpu_torch.models.decoder against nvfpcc_tpu.models.decoder on equal
params (moved across with utils.params): reconstruct, get_latent_code, the
flagship-width eval forward, and the train-mode forward with the JAX
package's noise injected. Tolerance: f32, atol 1e-5 on occupancy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu_torch.models import decoder as TM
from nvfpcc_tpu_torch.utils.params import params_from_numpy, params_to_numpy

ATOL = 1e-5


def _trained_like(ch, chanstr, n_blocks, seed):
    """A JAX params tree (numpy) with nonzero residuals everywhere + embeddings."""
    spec = JM.build_model_spec(ch, chanstr)
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(spec))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), tree
    )
    tree["entropy"]["sigma"] = np.abs(tree["entropy"]["sigma"]) + 0.5
    emb = rng.normal(0, 2, (n_blocks, 2, 2, 2, ch)).astype(np.float32)
    return spec, tree, emb


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def small():
    spec, tree, emb = _trained_like(2, (4, 8, 4, 4), 5, seed=0)
    net = params_from_numpy(TM.init_params(TM.build_model_spec(2, (4, 8, 4, 4))), tree)
    return spec, tree, emb, net


def test_params_roundtrip_is_identical(small):
    _, tree, _, net = small
    back = params_to_numpy(net)
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
        assert flat_b[path].dtype == np.float32


def test_seeded_inits_are_the_jax_bits():
    jspec = JM.build_model_spec(3, (8, 16, 8, 8))
    tspec = TM.build_model_spec(3, (8, 16, 8, 8))
    assert set(tspec.specs) == set(jspec.specs)
    for name, s in tspec.specs.items():
        np.testing.assert_array_equal(s.kernel_init, jspec.specs[name].kernel_init)
        np.testing.assert_array_equal(s.b_init, jspec.specs[name].b_init)
    assert TM.count_transmitted_residuals(tspec) == JM.count_transmitted_residuals(jspec)
    np.testing.assert_array_equal(TM.init_embeddings(5, 3).numpy(), np.asarray(JM.init_embeddings(5, 3)))
    assert TM.TRANSMITTED_KERNELS == JM.TRANSMITTED_KERNELS


def test_reconstruct_and_latent_code(small):
    spec, tree, emb, net = small
    jcode = JM.get_latent_code(spec, _jtree(tree), jnp.asarray(emb))
    with torch.no_grad():
        tcode = TM.get_latent_code(net, torch.as_tensor(emb))
        np.testing.assert_array_equal(
            tcode["quantized_latent"].numpy(), np.asarray(jcode["quantized_latent"])
        )
        assert abs(float(tcode["latent_bits"]) - float(jcode["latent_bits"])) < 1e-3
        for k in ("sigma", "mu"):
            np.testing.assert_array_equal(tcode[k].numpy(), np.asarray(jcode[k]))
        lat = np.array(jcode["quantized_latent"])
        want = np.asarray(JM.reconstruct(spec, _jtree(tree), jnp.asarray(lat)))
        got = TM.reconstruct(net.decoder, torch.as_tensor(lat)).numpy()
    assert got.shape == want.shape == (5, 32, 32, 32, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_network_bits(small):
    spec, tree, _, net = small
    want = JM.get_network_bits(spec, _jtree(tree))
    with torch.no_grad():
        got = TM.get_network_bits(net)
    assert abs(got - want) <= 1e-4 * abs(want)


def test_flagship_width_eval_forward():
    """ch=3, chanstr 8,16,8,8 (the served width) on a few blocks, q=2."""
    spec, tree, emb = _trained_like(3, (8, 16, 8, 8), 3, seed=1)
    want_occ, want_cls, want_nb, want_lb = JM.net_apply(spec, _jtree(tree), jnp.asarray(emb), "eval", 2)
    net = params_from_numpy(TM.init_params(TM.build_model_spec(3, (8, 16, 8, 8))), tree)
    with torch.no_grad():
        lat = net.latent_gen(torch.as_tensor(emb))
        rounded, bits = TM.entropy_apply(net, lat, "eval")
        occ, cls, nb = net.decoder(rounded, q=2)
    np.testing.assert_allclose(occ.numpy(), np.asarray(want_occ), atol=ATOL, rtol=0)
    for a, b in zip(cls[:2], want_cls[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(nb.numpy(), np.asarray(want_nb), rtol=1e-4)
    np.testing.assert_allclose(bits.reshape(3, -1).sum(1).numpy(), np.asarray(want_lb), rtol=1e-4)


def test_train_mode_forward_with_injected_noise(small):
    """q=1 + train-mode bottleneck: the JAX package draws its noise from a
    key; the same draws are handed to the port."""
    spec, tree, emb, net = small
    key = jax.random.PRNGKey(11)
    want_occ, want_cls, want_nb, want_lb = JM.net_apply(
        spec, _jtree(tree), jnp.asarray(emb), "train", 1, key
    )
    # replay JM.net_apply's key use: (ekey, dkey); decoder keys split 7 ways
    ekey, dkey = jax.random.split(key)
    lat_shape = (emb.shape[0], 2, 2, 2, spec.ch)
    e_noise = np.asarray(jax.random.uniform(ekey, lat_shape, jnp.float32, -0.5, 0.5))
    k_noise = {
        n: torch.as_tensor(np.array(jax.random.uniform(
            k, spec.specs[n].kernel_shape, jnp.float32, -0.5, 0.5)))
        for n, k in zip(JM.TRANSMITTED_KERNELS, jax.random.split(dkey, 7))
    }
    with torch.no_grad():
        lat = net.latent_gen(torch.as_tensor(emb))
        rounded, bits = TM.entropy_apply(net, lat, "train", torch.as_tensor(e_noise))
        occ, cls, nb = net.decoder(rounded, q=1, noise=k_noise)
    np.testing.assert_allclose(occ.numpy(), np.asarray(want_occ), atol=ATOL, rtol=0)
    for a, b in zip(cls[:2], want_cls[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL, rtol=0)
    np.testing.assert_allclose(nb.numpy(), np.asarray(want_nb), rtol=1e-4)
    np.testing.assert_allclose(bits.reshape(len(emb), -1).sum(1).numpy(), np.asarray(want_lb), rtol=1e-4)


def test_train_mode_needs_noise(small):
    _, _, emb, net = small
    with pytest.raises(ValueError, match="noise"):
        TM.entropy_apply(net, torch.as_tensor(emb), "train")


@pytest.mark.parametrize("mode", ["spatio", "gmm", "factorized", "ctx", "ctx_ar"])
def test_other_entropy_modes_not_ported(mode):
    """The name predates the port of these modes: every one now builds its
    spec. spatio, gmm and factorized keep the channel layers and carry an
    entropy subtree of the JAX package's leaf names and shapes
    (tests/test_torch_entropy_modes.py holds their values and rates against
    it); ctx and ctx_ar add the masked predictor (tests/test_torch_ctx.py)."""
    if mode not in TM.CTX_MODES:
        spec = TM.build_model_spec(2, (4, 8, 4, 4), entropy_mode=mode)
        assert set(spec.specs) == set(TM.build_model_spec(2, (4, 8, 4, 4)).specs)
        want = JM.init_params(JM.build_model_spec(2, (4, 8, 4, 4), entropy_mode=mode))["entropy"]
        got = {n: tuple(p.shape) for n, p in TM.init_params(spec).entropy.named_parameters()}
        assert got == {n: tuple(np.shape(v)) for n, v in want.items()}
        if mode == "factorized":
            assert got["matrix_0"] == (2, 1, 3) and got["matrix_3"] == (2, 3, 1) and len(got) == 11
        else:
            assert got["sigma"] == ((2, 2, 2, 2) if mode == "spatio" else (2, 2))
        return
    spec = TM.build_model_spec(2, (4, 8, 4, 4), entropy_mode=mode)
    plain = TM.build_model_spec(2, (4, 8, 4, 4))
    assert set(spec.specs) == set(plain.specs) | {"ctx1", "ctx2"}
    for name, s in plain.specs.items():
        np.testing.assert_array_equal(spec.specs[name].kernel_init, s.kernel_init)
    assert spec.specs["ctx1"].kernel_shape == (3, 3, 3, 2, 8) and spec.specs["ctx2"].kernel_shape == (3, 3, 3, 8, 4)
    assert spec.specs["ctx2"].mask is not None and isinstance(TM.init_params(spec).entropy, TM.CtxPredictor)
