"""Shared by the port's training and codec tests (tests/test_torch_losses.py,
tests/test_torch_train.py, tests/test_torch_ctx_train.py,
tests/test_torch_entropy_modes.py, tests/test_torch_recon_bf16.py,
tests/test_torch_parallel.py, tests/test_torch_realdata*.py): the toy
training set, the JAX package's noise replayed for the port (or recorded
for processes without JAX), a JAX training state carried into the port
(and both compared as numpy), the check that two packages' point sets
differ only near the threshold, and a real-data fixture through the port
CLI. The model is the channel-mode toy unless a JAX spec is given."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.train import loop as JT
from nvfpcc_tpu_torch.models import decoder as TM
from nvfpcc_tpu_torch.train import loop as TT
from nvfpcc_tpu_torch.utils import params as TP

CH, CHANNELS, CHANSTR = 2, (4, 8, 4, 4), "4,8,4,4"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Import into a test module to run its torch work on one thread. The
    shapes are tiny, and with several xdist workers on one host torch's
    intra-op threads oversubscribe the cores: a 1.5 s test was measured at
    107 s in a 6-worker run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def toy_grids(n_blocks=6, seed=0, empty_block=None):
    """Random sparse occupancy + a distance-like field (the JAX suite's toy)."""
    rng = np.random.default_rng(seed)
    gt = (rng.uniform(0, 1, (n_blocks, 32, 32, 32)) < 0.02).astype(np.uint8)
    if empty_block is not None:
        gt[empty_block] = 0
    dist = (rng.uniform(0, 6, gt.shape) * (1 - gt)).astype(np.float32)
    return gt, dist


def trained_like(n_blocks, seed=0, scale=0.05):
    """A JAX params tree (numpy) with nonzero residuals everywhere + embeddings."""
    spec = JM.build_model_spec(CH, CHANNELS)
    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(spec))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: (a + rng.normal(0, scale, a.shape)).astype(np.float32), tree
    )
    tree["entropy"]["sigma"] = np.abs(tree["entropy"]["sigma"]) + 0.5
    emb = rng.normal(0, 2, (n_blocks, 2, 2, 2, CH)).astype(np.float32)
    return spec, tree, emb


def jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _uniform(key, shape):
    return torch.as_tensor(np.array(jax.random.uniform(key, tuple(shape), jnp.float32, -0.5, 0.5)))


def noise_from_key(key, latent_shape, q, spec=None):
    """The draws ``JM.net_apply`` makes from ``key``: (ekey, dkey) = split;
    at q=1 the seven kernel noises from split(dkey, 7). Channel mode: the
    latent noise from ekey at either q. ctx modes draw only at q=1: (nkey,
    pkey) = split(ekey), the latent noise from nkey, the ctx1/ctx2 kernel
    noises from split(pkey)."""
    spec = spec or JM.build_model_spec(CH, CHANNELS)
    ekey, dkey = jax.random.split(key)
    out = {}
    if spec.entropy_mode in JM.CTX_MODES:
        if q == 1:
            nkey, pkey = jax.random.split(ekey)
            out["latent"] = _uniform(nkey, latent_shape)
            for n, k in zip(JM.CTX_KERNELS, jax.random.split(pkey)):
                out[n] = _uniform(k, spec.specs[n].kernel_shape)
    else:
        out["latent"] = _uniform(ekey, latent_shape)
    if q == 1:
        for n, k in zip(JM.TRANSMITTED_KERNELS, jax.random.split(dkey, 7)):
            out[n] = _uniform(k, spec.specs[n].kernel_shape)
    return out


class JaxReplayNoise:
    """A noise source for the port's epoch that replays the JAX epoch's
    draws: an epoch's keys are split(fold_in(PRNGKey(seed), epoch),
    n_batches + 1), the last one for the embedding update (split again per
    chunk when it is chunked)."""

    def __init__(self, seed, emb_chunks=1, spec=None):
        self.seed, self.emb_chunks, self.spec = seed, emb_chunks, spec

    def start_epoch(self, epoch, n_batches):
        keys = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(self.seed), epoch), n_batches + 1
        )
        last = [keys[-1]] if self.emb_chunks <= 1 else list(jax.random.split(keys[-1], self.emb_chunks))
        self.keys = list(keys[:n_batches]) + last
        self.calls = 0

    def draw(self, latent_shape, q):
        key = self.keys[self.calls]
        self.calls += 1
        return noise_from_key(key, latent_shape, q, self.spec)


def record_jax_noise(seed, n_blocks, batch_size, epochs, phase_change, spec=None):
    """:class:`JaxReplayNoise`'s draws for whole epochs of an unchunked run,
    as numpy (``torch_recorded_noise.RecordedNoise`` replays them):
    {epoch: [one draw per batch at (batch_size, 2, 2, 2, CH), then the
    embedding update's at (n_blocks, 2, 2, 2, CH)]}."""
    n_batches = -(-n_blocks // batch_size)
    src, out = JaxReplayNoise(seed, spec=spec), {}
    for epoch in range(epochs):
        q = 1 if epoch < phase_change else 2
        src.start_epoch(epoch, n_batches)
        shapes = [(batch_size, 2, 2, 2, CH)] * n_batches + [(n_blocks, 2, 2, 2, CH)]
        out[epoch] = [{k: v.numpy() for k, v in src.draw(s, q).items()} for s in shapes]
    return out


def jax_state_numpy(params, opt_state, emb, emb_opt_state):
    """A JAX training state as numpy: params tree, net Adam (mu, nu flat,
    count), embeddings, embedding Adam (mu, nu, count)."""
    adam, eadam = opt_state[0], emb_opt_state[0]
    return {
        "params": jax.tree_util.tree_map(np.asarray, params),
        "mu": {k: np.asarray(v) for k, v in TP.flatten_tree(adam.mu).items()},
        "nu": {k: np.asarray(v) for k, v in TP.flatten_tree(adam.nu).items()},
        "count": int(adam.count),
        "emb": np.asarray(emb),
        "emb_mu": np.asarray(eadam.mu), "emb_nu": np.asarray(eadam.nu),
        "emb_count": int(eadam.count),
    }


def port_state_from_numpy(cfg, s, tspec=None) -> TT.TrainState:
    """The port's TrainState holding the numpy state ``s`` (jax_state_numpy's
    layout), on the port spec ``tspec`` (default the channel toy)."""
    net = TP.params_from_numpy(TM.init_params(tspec or TM.build_model_spec(CH, CHANNELS)), s["params"])
    emb = torch.as_tensor(np.array(s["emb"], np.float32)).requires_grad_(True)
    opt, emb_opt = TT.make_optimizers(cfg, net, emb)
    TP.adam_state_from_numpy(opt, TP.named_params(net), s["mu"], s["nu"], s["count"])
    TP.adam_state_from_numpy(
        emb_opt, {"emb": emb}, {"emb": s["emb_mu"]}, {"emb": s["emb_nu"]}, s["emb_count"]
    )
    return TT.TrainState(net, opt, emb, emb_opt)


def assert_state_close(got, want, atol=5e-6):
    """Two training states (jax_state_numpy's layout) agree: step counts
    exactly, params and embeddings to ``atol``, Adam first and second
    moments to 1e-3 and 2e-3 of each leaf's largest magnitude."""
    assert got["count"] == want["count"] and got["emb_count"] == want["emb_count"]
    gp, wp = TP.flatten_tree(got["params"]), TP.flatten_tree(want["params"])
    assert set(gp) == set(wp)

    def rel(a, b, tol, what):
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), what

    for k in wp:
        assert gp[k].dtype == np.float32
        np.testing.assert_allclose(gp[k], wp[k], rtol=0, atol=atol, err_msg=k)
        rel(got["mu"][k], want["mu"][k], 1e-3, f"mu {k}")
        rel(got["nu"][k], want["nu"][k], 2e-3, f"nu {k}")
    np.testing.assert_allclose(got["emb"], want["emb"], rtol=0, atol=atol)
    rel(got["emb_mu"], want["emb_mu"], 1e-3, "emb mu")
    rel(got["emb_nu"], want["emb_nu"], 2e-3, "emb nu")


def port_state_numpy(state: TT.TrainState):
    mu, nu, count = TP.adam_state_to_numpy(state.opt, TP.named_params(state.net))
    emu, enu, ecount = TP.adam_state_to_numpy(state.emb_opt, {"emb": state.emb})
    return {
        "params": TP.params_to_numpy(state.net), "mu": mu, "nu": nu, "count": count,
        "emb": state.emb.detach().numpy(), "emb_mu": emu["emb"], "emb_nu": enu["emb"],
        "emb_count": ecount,
    }


def jax_fresh_state(jcfg, n_blocks, tree=None, emb=None, spec=None):
    """(spec, params, opt_state, emb, emb_opt_state, net_opt, emb_opt) at a
    run's start, or from a given numpy tree / embeddings (on the JAX spec
    ``spec``, default the channel toy)."""
    spec = spec or JM.build_model_spec(CH, CHANNELS)
    params = JM.init_params(spec) if tree is None else jtree(tree)
    emb = JM.init_embeddings(n_blocks, CH) if emb is None else jnp.asarray(emb)
    net_opt, emb_opt = JT.make_optimizers(jcfg, -(-n_blocks // jcfg.batch_size))
    return spec, params, net_opt.init(params), emb, emb_opt.init(emb), net_opt, emb_opt


def assert_only_band_differs(a, b, pack, band):
    """Points in one set and not the other lie within ``band`` of the pack's
    ``thh`` in the port's occupancy field for this pack (any entropy mode,
    the pack's ``recon_dtype``)."""
    from nvfpcc_tpu_torch import codec as TC
    from nvfpcc_tpu_torch.codec import weights as TW
    from nvfpcc_tpu_torch.config import ModelConfig

    diff = set(map(tuple, a)) ^ set(map(tuple, b))
    if not diff:
        return
    mc = pack["model"]
    spec = TC.model_spec(ModelConfig(ch=int(mc["ch"]), chanstr=mc["chanstr"], seed_tag=mc["seed_tag"],
                                     entropy_mode=mc.get("entropy_mode", "channel")))
    occ = TC.reconstruct_all(
        TC.decoder_from_tree(spec, TW.unpack_weights(pack["net_weight_pack"]), "cpu",
                             pack["codec"].get("recon_dtype", "f32")),
        TC.decode_latent_pack(spec, pack["latent_pack"]),
    )
    origins = TC.decode_origins(pack["origins"], int(pack["codec"]["depth"]), int(pack["codec"]["level"]))
    block_of = {tuple(o): i for i, o in enumerate(origins)}
    bsz, thh = occ.shape[1], float(pack["codec"]["thh"])
    for p in diff:
        p = np.asarray(p)
        o = tuple((p // bsz) * bsz)
        v = p - np.asarray(o)
        assert abs(occ[block_of[o], v[0], v[1], v[2]] - thh) < band, p


def fixture_path(fixture: str) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", fixture)


def realdata_pipeline(workdir, fixture: str, thh: str):
    """A ``tests/fixtures`` cloud through the port CLI's whole path on the
    CPU (grids -> train -> encode -> decode -> eval) at the JAX
    real-data test's settings (``tests/test_real_data_readiness.py``: ch 2,
    chanstr 4,8,4,4, 8 epochs, phase change 3, batch 4, eval every 4) and
    the decode threshold ``thh``: each step's exit status and output, the
    paths, and the grids npz."""
    import contextlib
    import io
    import shutil
    import types

    from nvfpcc_tpu_torch.cli import artifact_path, main as cli_main

    d = str(workdir)
    cloud = os.path.join(d, fixture)
    shutil.copy(fixture_path(fixture), cloud)
    r = types.SimpleNamespace(cloud=cloud, thh=thh, **{k: os.path.join(d, f) for k, f in (
        ("ckpt", "ckpts"), ("pack", "pack.pk"), ("rc_enc", "rc_enc.ply"), ("rc_dec", "rc_dec.ply"))},
        rcs={}, out={})
    common = ["--depth", "10", "--level", "5", "--platform", "cpu"]
    small = ["--ch", str(CH), "--chanstr", CHANSTR]
    steps = {
        "grids": ["grids", cloud, *common],
        "train": ["train", cloud, *common, *small, "--epochs", "8", "--phase_change", "3", "--batchsize", "4",
                  "--checkpoint_dir", r.ckpt, "--eval_every", "4"],
        "encode": ["encode", cloud, *common, *small, "--load_checkpoint", r.ckpt, "--pack_fn", r.pack,
                   "--recon", r.rc_enc, "--thh", thh],
        "decode": ["decode", r.pack, "--recon", r.rc_dec, "--platform", "cpu"],
        "eval": ["eval", cloud, r.rc_dec, *common],
    }
    for step, argv in steps.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r.rcs[step] = cli_main(argv)
        r.out[step] = buf.getvalue()
    with np.load(artifact_path(cloud, 10, 5)) as art:
        r.art = {k: art[k] for k in ("origins", "gt", "dist")}
    return r


def assert_fixture_reads_alike(fixture: str) -> np.ndarray:
    """Both packages' PLY readers give the fixture the same points; returns them."""
    from nvfpcc_tpu.io.ply import read_ply_points as jax_read_ply_points
    from nvfpcc_tpu_torch.io.ply import read_ply_points

    pts = read_ply_points(fixture_path(fixture))
    assert np.array_equal(pts, jax_read_ply_points(fixture_path(fixture)))
    return pts


def assert_round_trip(run) -> None:
    """Every step of ``realdata_pipeline`` exited 0, ``rc_enc == rc_dec``
    byte for byte, and the reconstruction holds points."""
    from nvfpcc_tpu_torch.io.ply import read_ply_points

    assert run.rcs == {"grids": 0, "train": 0, "encode": 0, "decode": 0, "eval": 0}
    with open(run.rc_enc, "rb") as a, open(run.rc_dec, "rb") as b:
        assert a.read() == b.read(), "rc_enc != rc_dec"
    assert len(read_ply_points(run.rc_dec)) > 0, f"empty reconstruction at thh {run.thh}"


def assert_finite_d1(run) -> None:
    m = re.search(r"D1 PSNR ([-\w.]+) dB", run.out["eval"])
    assert m and np.isfinite(float(m[1])), run.out["eval"]
