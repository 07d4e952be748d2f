"""The port's spatio, gmm and factorized latent entropy modes against
nvfpcc_tpu on the CPU, at the JAX suite's size (ch=2, chanstr 4,8,4,4):
the rate functions and their gradients against ``jax.grad``, the entropy
inits, the bottleneck in eval and in train with the noise injected, the
latent code and the network bits, params and checkpoints crossing both
ways, and one q=2 gmm epoch with the JAX package's noise replayed.

Tolerances (f32): per-element bits and their gradients rtol 1e-5 with an
atol of 1e-5 of the largest magnitude (measured under 2e-6); latent bits per
block rtol 1e-5; network bits rtol 1e-6 (a sum of about 72k bits in float64
on both sides); params and embeddings after the epoch atol 2e-5, Adam
moments 1e-3 / 2e-3 of a leaf's largest magnitude (as for the ctx epoch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from nvfpcc_tpu.config import TrainConfig as JaxTrainConfig
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.ops import rate as JR
from nvfpcc_tpu.train import loop as JT
from nvfpcc_tpu.utils import checkpoint as JCK
from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.models import decoder as TM
from nvfpcc_tpu_torch.ops import rate as TR
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import checkpoint as TCK
from nvfpcc_tpu_torch.utils import params as TP

MODES = ("spatio", "gmm", "factorized")
CH = H.CH


def _specs(mode):
    return JM.build_model_spec(CH, H.CHANNELS, entropy_mode=mode), TM.build_model_spec(CH, H.CHANNELS, entropy_mode=mode)


def _tree(jspec, seed=0, scale=0.05):
    """A JAX params tree (numpy) with every leaf moved off its init."""
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(jspec))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (a + rng.normal(0, scale, a.shape)).astype(np.float32), tree)


def _t(tree):
    return {k: torch.tensor(np.asarray(v), requires_grad=True) for k, v in tree.items()}


def _close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(np.abs(want).max(), 1e-30), err_msg=what)


# ---------------------------------------------------------------- rates

RATES = {
    # name: (jax bits(x, params), port bits(x, params), params)
    "gaussian": (lambda x, p: JR.gaussian_bits(x, p["sigma"], p["mu"]),
                 lambda x, p: TR.gaussian_bits(x, p["sigma"], p["mu"]),
                 {"sigma": np.array([0.3, 1.7, 4.0], np.float32), "mu": np.array([0.2, -1.1, 0.0], np.float32)}),
    "laplace": (lambda x, p: JR.laplace_bits(x, p["sigma"], p["mu"]),
                lambda x, p: TR.laplace_bits(x, p["sigma"], p["mu"]),
                {"sigma": np.array([0.3, 1.7, 4.0], np.float32), "mu": np.array([0.2, -1.1, 0.0], np.float32)}),
    "gmm2": (JR.gmm2_bits, TR.gmm2_bits,
             {"sigma": np.array([[0.6, -1.3, 2.0], [3.0, 0.4, -0.9]], np.float32),
              "mu": np.array([[-0.7, 0.1, 1.5], [0.9, -2.0, 0.0]], np.float32),
              "p_logit": np.array([0.3, -1.2, 2.2], np.float32)}),
    "factorized": (JR.factorized_bits, TR.factorized_bits, None),
}


def _factorized_params(seed=1):
    rng = np.random.default_rng(seed)
    init = jax.tree_util.tree_map(np.asarray, JR.factorized_init(3))
    return {k: (v + rng.normal(0, 0.4, v.shape)).astype(np.float32) for k, v in init.items()}


@pytest.mark.parametrize("name", list(RATES))
def test_rate_bits_and_gradients_match_jax(name):
    """Per-element bits of seeded channels-last latents, and the gradients
    of their sum w.r.t. the latents and every rate parameter."""
    jfn, tfn, params = RATES[name]
    params = params if params is not None else _factorized_params()
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 3, (40, 3)), np.rint(rng.normal(0, 3, (40, 3)))]).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(jfn(jnp.asarray(x), jp))
    gx, gp = jax.grad(lambda x_, p_: jfn(x_, p_).sum(), argnums=(0, 1))(jnp.asarray(x), jp)
    tx, tp = torch.tensor(x, requires_grad=True), _t(params)
    got = tfn(tx, tp)
    got.sum().backward()
    _close(got.detach().numpy(), want, f"{name} bits")
    _close(tx.grad.numpy(), gx, f"{name} d/dx")
    for k in params:
        _close(tp[k].grad.numpy(), gp[k], f"{name} d/d{k}")


def test_factorized_softplus_above_20_and_the_sign_floor():
    """A matrix entry above 20, where ``F.softplus`` would switch to the
    identity, and latents far in the tail, where the sign trick's floor
    (1e-9) binds: bits and gradients as in JAX."""
    params = _factorized_params(2)
    params["matrix_1"][0, 1, 2] = 23.5
    params["matrix_3"][1, 0, 0] = 20.75
    x = np.array([[0.0, 1.0, -2.0], [40.0, -55.0, 3.0], [1e4, -1e4, 0.5]], np.float32)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    want = np.asarray(JR.factorized_bits(jnp.asarray(x), jp))
    gp = jax.grad(lambda p_: JR.factorized_bits(jnp.asarray(x), p_).sum())(jp)
    tp = _t(params)
    got = TR.factorized_bits(torch.tensor(x), tp)
    got.sum().backward()
    assert np.isclose(want.max(), -np.log2(1e-9), rtol=1e-6)  # the floor is reached
    _close(got.detach().numpy(), want, "bits")
    for k in params:
        _close(tp[k].grad.numpy(), gp[k], f"d/d{k}")
    big = torch.tensor([20.75, 23.5, 88.0])
    np.testing.assert_array_equal(TR.softplus(big).numpy(), np.asarray(jax.nn.softplus(jnp.asarray(big.numpy()))))


# ------------------------------------------------------------- the model


@pytest.mark.parametrize("mode", MODES)
def test_entropy_init_equals_jax(mode):
    jspec, tspec = _specs(mode)
    want = TP.flatten_tree(jax.tree_util.tree_map(np.asarray, JM.init_params(jspec)["entropy"]))
    got = TP.flatten_tree(TP.params_to_numpy(TM.init_params(tspec).entropy))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("mode", MODES)
def test_bottleneck_latent_code_and_network_bits(mode):
    """``entropy_apply`` in eval and in train (the noise JAX draws from its
    key handed to the port), ``get_latent_code`` and ``get_network_bits``."""
    jspec, tspec = _specs(mode)
    tree = _tree(jspec)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    net = TP.params_from_numpy(TM.init_params(tspec), tree)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 3, (4, 2, 2, 2, CH)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    noise = torch.as_tensor(np.array(jax.random.uniform(key, x.shape, jnp.float32, -0.5, 0.5)))
    for m, k, nz in (("eval", None, None), ("train", key, noise)):
        jr, jb = JM.entropy_apply(jspec, jp, jnp.asarray(x), m, k)
        tr, tb = TM.entropy_apply(net, torch.as_tensor(x), m, nz)
        np.testing.assert_array_equal(tr.detach().numpy(), np.asarray(jr))
        np.testing.assert_allclose(tb.detach().numpy().reshape(4, -1).sum(1),
                                   np.asarray(jb).reshape(4, -1).sum(1), rtol=1e-5, err_msg=m)
    emb = rng.normal(0, 2, (5, 2, 2, 2, CH)).astype(np.float32)
    jc = JM.get_latent_code(jspec, jp, jnp.asarray(emb))
    with torch.no_grad():
        tc = TM.get_latent_code(net, torch.as_tensor(emb))
    assert set(tc) == set(jc)
    np.testing.assert_array_equal(tc["quantized_latent"].numpy(), np.asarray(jc["quantized_latent"]))
    np.testing.assert_allclose(float(tc["latent_bits"]), float(jc["latent_bits"]), rtol=1e-5)
    if mode == "spatio":
        assert tuple(tc["sigma"].shape) == (2, 2, 2, CH)
        np.testing.assert_array_equal(tc["sigma"].detach().numpy(), np.asarray(jc["sigma"]))
        np.testing.assert_array_equal(tc["mu"].detach().numpy(), np.asarray(jc["mu"]))
    with torch.no_grad():
        got_bits = TM.get_network_bits(net)
    np.testing.assert_allclose(got_bits, JM.get_network_bits(jspec, jp), rtol=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_params_and_checkpoints_cross_both_ways(mode, tmp_path):
    """The entropy subtree maps leaf for leaf; a JAX checkpoint with its
    ``entropy_mode`` loads into the port's model, and the port's checkpoint
    loads in the JAX package with the same leaves and metadata."""
    jspec, tspec = _specs(mode)
    tree = _tree(jspec, seed=4)
    back = TP.flatten_tree(TP.params_to_numpy(TP.params_from_numpy(TM.init_params(tspec), tree)))
    flat = TP.flatten_tree(tree)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    emb = np.random.default_rng(0).normal(0, 2, (3, 2, 2, 2, CH)).astype(np.float32)
    meta = TT.checkpoint_meta(ModelConfig(ch=CH, chanstr=H.CHANSTR, entropy_mode=mode))
    jpath = JCK.save_checkpoint(str(tmp_path / "j"), 4, tree, emb, meta=meta)
    params, temb, tmeta = TCK.load_checkpoint_meta(jpath)
    assert tmeta["entropy_mode"] == mode
    TP.params_from_numpy(TM.init_params(TM.build_model_spec(CH, H.CHANNELS, entropy_mode=tmeta["entropy_mode"])),
                         params)
    tpath = TCK.save_checkpoint(str(tmp_path / "t"), 4, params, temb, meta=tmeta)
    jparams, jemb, jmeta = JCK.load_checkpoint_meta(tpath)
    assert jmeta == meta
    np.testing.assert_array_equal(jemb, emb)
    jflat = TP.flatten_tree(jax.tree_util.tree_map(np.asarray, jparams))
    for k in flat:
        np.testing.assert_array_equal(jflat[k], flat[k], err_msg=k)


class _OneEpochReplay(H.JaxReplayNoise):
    def start_epoch(self, epoch, n_batches):
        super().start_epoch(3, n_batches)


def test_one_gmm_epoch_matches_make_epoch_fn():
    """One whole q=2 gmm epoch (per-batch net steps, then the full-set
    embedding update) from a trained-like start, with the latent noise JAX
    draws at q=2 replayed: the mixture's leaves go through the net Adam."""
    n = 6
    gt, dist = H.toy_grids(n)
    jspec, tspec = _specs("gmm")
    tree = _tree(jspec)
    emb = np.random.default_rng(0).normal(0, 2, (n, 2, 2, 2, CH)).astype(np.float32)
    jcfg = JaxTrainConfig(batch_size=4, compute_dtype="f32")
    tcfg = TrainConfig(batch_size=4, compute_dtype="f32")
    npts = float(gt.sum())
    spec, params, opt_state, jemb, emb_opt_state, net_opt, emb_opt = H.jax_fresh_state(
        jcfg, n, tree, emb, spec=jspec)
    start = H.jax_state_numpy(params, opt_state, jemb, emb_opt_state)
    idx, mask = JT.batch_plan(n, 4, "stride", 0, 3)
    gt_d, dist_d = JT._prep_dense(gt, dist)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    p1, o1, e1, eo1, _ = JT.make_epoch_fn(spec, jcfg, net_opt, emb_opt, npts, 2)(
        params, opt_state, jnp.copy(jemb), emb_opt_state, gt_d, dist_d, jnp.asarray(idx),
        jnp.asarray(mask), jnp.ones((n,), jnp.float32), key, JT.rd_weights(jcfg))
    want = H.jax_state_numpy(p1, o1, e1, eo1)

    state = H.port_state_from_numpy(tcfg, start, tspec)
    tg, td = TT._prep_dense(gt, dist, "cpu")
    stacked = TT.run_epoch(state, tcfg, tg, td, torch.as_tensor(idx).long(), torch.as_tensor(mask),
                           torch.ones(n), npts, 2, _OneEpochReplay(0, spec=jspec), 0)
    assert torch.isfinite(stacked).all()
    H.assert_state_close(H.port_state_numpy(state), want, atol=2e-5)
    moved = want["params"]["entropy"]["p_logit"] - start["params"]["entropy"]["p_logit"]
    assert np.abs(moved).max() > 1e-4  # the mixture trained
