"""The port's trainer in the ctx family against nvfpcc_tpu.train.loop on the
CPU (ch=2, chanstr 4,8,4,4, 6 blocks of 32^3, batch 4, f32): one whole
ctx_ar epoch with tail units at q=2, where ctx training draws no noise at
all, and one at q=1 with the JAX package's keys replayed (the ctx
bottleneck splits its key once more for the latent noise and twice more for
the predictor's kernel noise); the chunked embedding update equal to the
unchunked one at q=2; and a short ``train()`` in ctx mode with its
checkpoint metadata and the feature init.

Tolerances (f32, from the same trained-like start): params and embeddings
atol 2e-5 (measured: embeddings 2.4e-7; decoder kernels 5.2e-6 at q=2 and
9.9e-6 at q=1, in conv0/up1, where elements with a near-zero gradient take
Adam steps close to lr * sign(g), which amplifies rounding; params move by
about 2e-3 in the epoch); Adam moments 1e-3 / 2e-3 of a leaf's largest
magnitude; chunked against unchunked embedding gradient rtol 1e-5, atol
1e-6 of its largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_train_helpers as H
from torch_train_helpers import assert_state_close
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)
from nvfpcc_tpu.config import TrainConfig as JaxTrainConfig
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.train import loop as JT
from nvfpcc_tpu_torch.config import ModelConfig, TrainConfig
from nvfpcc_tpu_torch.models import decoder as TM
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import checkpoint as TCK
from nvfpcc_tpu_torch.utils import params as TP

N = 6
EPOCH = 3
KW = dict(entropy_mode="ctx_ar", ctx_hidden=8, ctx_tail=3)


@pytest.fixture(scope="module")
def toy():
    gt, dist = H.toy_grids(N)
    jspec = JM.build_model_spec(H.CH, H.CHANNELS, **KW)
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(jspec))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), tree)
    emb = rng.normal(0, 2, (N, 2, 2, 2, H.CH)).astype(np.float32)
    return {"gt": gt, "dist": dist, "npts": float(gt.sum()), "tree": tree, "emb": emb, "jspec": jspec,
            "tspec": TM.build_model_spec(H.CH, H.CHANNELS, **KW)}


class _OneEpochReplay(H.JaxReplayNoise):
    def start_epoch(self, epoch, n_batches):
        super().start_epoch(EPOCH, n_batches)


@pytest.mark.parametrize("q", [1, 2])
def test_one_ctx_ar_epoch_matches_make_epoch_fn(toy, q):
    """q=2 runs on the port's own noise source, which draws nothing in ctx
    modes at q=2; q=1 replays the JAX keys."""
    jcfg = JaxTrainConfig(batch_size=4, compute_dtype="f32")
    tcfg = TrainConfig(batch_size=4, compute_dtype="f32")
    spec, params, opt_state, emb, emb_opt_state, net_opt, emb_opt = H.jax_fresh_state(
        jcfg, N, toy["tree"], toy["emb"], spec=toy["jspec"])
    start = H.jax_state_numpy(params, opt_state, emb, emb_opt_state)
    idx, mask = JT.batch_plan(N, 4, "stride", 0, EPOCH)
    gt_d, dist_d = JT._prep_dense(toy["gt"], toy["dist"])
    key = jax.random.fold_in(jax.random.PRNGKey(0), EPOCH)
    p1, o1, e1, eo1, _ = JT.make_epoch_fn(spec, jcfg, net_opt, emb_opt, toy["npts"], q)(
        params, opt_state, jnp.copy(emb), emb_opt_state, gt_d, dist_d, jnp.asarray(idx),
        jnp.asarray(mask), jnp.ones((N,), jnp.float32), key, JT.rd_weights(jcfg))
    want = H.jax_state_numpy(p1, o1, e1, eo1)

    state = H.port_state_from_numpy(tcfg, start, toy["tspec"])
    noise = _OneEpochReplay(0, spec=toy["jspec"]) if q == 1 else TT.NoiseSource(0, toy["tspec"], "cpu")
    tg, td = TT._prep_dense(toy["gt"], toy["dist"], "cpu")
    stacked = TT.run_epoch(state, tcfg, tg, td, torch.as_tensor(idx).long(), torch.as_tensor(mask),
                           torch.ones(N), toy["npts"], q, noise, 0)
    assert torch.isfinite(stacked).all()
    assert_state_close(H.port_state_numpy(state), want, atol=2e-5)
    moved = TP.flatten_tree(want["params"])["entropy/ctx2/kernel"] - TP.flatten_tree(start["params"])["entropy/ctx2/kernel"]
    assert np.abs(moved).max() > 1e-4  # the predictor trained


def test_noise_source_draws_nothing_in_ctx_modes_at_q2(toy):
    src = TT.NoiseSource(0, toy["tspec"], "cpu")
    src.start_epoch(0, 1)
    assert src.draw((4, 2, 2, 2, H.CH), 2) == {}
    got = src.draw((4, 2, 2, 2, H.CH), 1)
    assert set(got) == {"latent", *JM.TRANSMITTED_KERNELS, *JM.CTX_KERNELS}
    assert tuple(got["ctx2"].shape) == toy["tspec"].specs["ctx2"].kernel_shape


def test_chunked_emb_update_equals_unchunked_at_q2(toy):
    """The vox11 shape of the update (5,326 blocks auto-chunk into 2): ctx at
    q=2 is key-free, so the chunks' gradients concatenate to the unchunked
    gradient up to reassociation. 8 blocks in 4 chunks here."""
    n = 8
    gt, dist = H.toy_grids(n, seed=7)
    cfg = TrainConfig(batch_size=4, compute_dtype="f32")
    net = TP.params_from_numpy(TM.init_params(toy["tspec"]), toy["tree"])
    emb = torch.as_tensor(np.random.default_rng(1).normal(0, 2, (n, 2, 2, 2, H.CH)).astype(np.float32))
    tg, td = TT._prep_dense(gt, dist, "cpu")
    noise = TT.NoiseSource(0, toy["tspec"], "cpu")
    grads = [TT.emb_full_grad(net, cfg, emb, tg, td, torch.ones(n), float(gt.sum()), 2, noise, c).numpy()
             for c in (1, 4)]
    scale = np.abs(grads[0]).max()
    assert scale > 0
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-6 * scale)
    assert TT.resolve_emb_chunks(0, 5326) == 2 and TT.EMB_CHUNK_BLOCKS == JT.EMB_CHUNK_BLOCKS


def test_ctx_train_writes_ctx_checkpoints(toy, tmp_path):
    """Two epochs (q=1, q=2) of ``train()`` in ctx_ar mode with the feature
    init and a detached predictor input: finite losses, 9 network-rate terms
    in b_net, and a checkpoint whose metadata and entropy subtree the JAX
    package reads."""
    from nvfpcc_tpu.utils import checkpoint as JCK

    logs = []
    mcfg = ModelConfig(ch=H.CH, chanstr=H.CHANSTR, ctx_train_init="feature", ctx_detach_pred=True, **KW)
    cfg = TrainConfig(batch_size=4, epochs=2, phase_change=1, eval_every=1, compute_dtype="f32", seed=3)
    spec, _ = TT.train(toy["gt"], toy["dist"], mcfg, cfg, "cpu", checkpoint_dir=str(tmp_path),
                       log=logs.append)
    assert spec.entropy_mode == "ctx_ar" and spec.ctx_tail == 3 and spec.ctx_detach_pred
    assert sum(" TRAIN " in x for x in logs) == 2
    params, emb, meta = JCK.load_checkpoint_meta(str(tmp_path / "0001.npz"))
    assert meta["entropy_mode"] == "ctx_ar" and meta["ctx_hidden"] == 8 and meta["ctx_tail"] == 3
    feat = TM.ctx_feature_init(toy["tspec"])
    k1 = np.asarray(params["entropy"]["ctx1"]["kernel"])
    assert np.abs(k1 - feat["ctx1"]["kernel"]).max() < 0.05  # started from the feature init
    _, _, tmeta = TCK.load_checkpoint_meta(str(tmp_path / "0001.npz"))
    assert tmeta == meta and emb.shape == (N, 2, 2, 2, H.CH)
