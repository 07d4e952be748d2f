"""The port's post-hoc context-predictor fit (``encode --ctx_post``) and the
encode's ``auto`` resolution against the JAX package on the CPU, and the
ctx drive through the port's CLI: train -> encode --ctx_post -> decode with
``rc_enc == rc_dec``.

The fit is chaotic at its lr of 3e-2: the two packages' trajectories agree
to 2.5e-4 over the first 10 steps and then part (float order), and the JAX
fit alone moves by up to 20% (2,092 to 2,504 bits on the test's latents)
when the blocks are merely permuted. So fitted kernels are not compared;
the fitted coding cost is, with a stated share of 25%: from the same
latents and 250 steps a phase, the port's fitted stream bits lie within 25%
of the JAX package's (measured 1,996 against 2,504), and both lie below 85%
of the marginal (a per-channel Gaussian moment fit, 3,260 bits, which a
context model must beat on latents with conditional structure). Encode and decode agree
whatever the fit did, because both ends predict from the quantized payload
in exact integers: the CLI test decodes packs from two different predictors.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import nvfpcc_tpu.cli as jax_cli
from nvfpcc_tpu.models import decoder as JM
from nvfpcc_tpu.ops import rate as jrate
from nvfpcc_tpu.train import ctx_fit as jfit
from nvfpcc_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from nvfpcc_tpu_torch import cli as port_cli
from nvfpcc_tpu_torch.io.ply import read_ply_points, write_ply_points
from nvfpcc_tpu_torch.models import decoder as TM
from nvfpcc_tpu_torch.serve import handle
from nvfpcc_tpu_torch.train import ctx_fit as tfit
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)

CH, CHANNELS = 2, (4, 8, 4, 4)


def _structured_latents(n=48, seed=0):
    """Integer latents with conditional structure (the JAX suite's): channel
    1 near-copies channel 0, plus a shared raster ramp."""
    rng = np.random.default_rng(seed)
    c0 = rng.integers(-6, 7, (n, 2, 2, 2, 1)) + np.arange(8).reshape(1, 2, 2, 2, 1)
    return np.concatenate([c0, c0 + rng.integers(0, 2, c0.shape)], -1).astype(np.int64)


def _jax_bits(jspec, ep, lat):
    x = jnp.asarray(lat, jnp.float32)
    mu, sigma = JM.ctx_pred_apply(jspec, {"entropy": ep}, x, q=2)
    return float(jrate.gaussian_bits(x, sigma, mu, step=1.0).sum())


def _marginal_bits(lat):
    """Bits under a per-channel Gaussian fitted to the latents' moments."""
    x = jnp.asarray(lat, jnp.float32)
    mu, sd = x.mean(axis=(0, 1, 2, 3)), x.std(axis=(0, 1, 2, 3))
    return float(jrate.gaussian_bits(x, sd, mu, step=1.0).sum())


def test_cosine_lr_is_optax_schedule():
    import optax

    sched = optax.cosine_decay_schedule(3e-2, 1000)
    for count in (0, 1, 249, 250, 999, 1000, 1500):
        assert tfit.cosine_lr(3e-2, 1000, count) == pytest.approx(float(sched(count)), rel=1e-6, abs=1e-9)


def test_fit_reaches_the_jax_fit_and_beats_the_marginal():
    """ctx_ar with tail units, the checkpoint-style weight-rate pricing on,
    250 steps a phase, no early stop, in both packages."""
    kw = dict(entropy_mode="ctx_ar", ctx_hidden=8, ctx_tail=3)
    jspec, tspec = JM.build_model_spec(CH, CHANNELS, **kw), TM.build_model_spec(CH, CHANNELS, **kw)
    lat = _structured_latents()
    wrate = {"sigma": np.asarray([0.5], np.float32), "mu": np.asarray([0.0], np.float32)}
    fit_kw = dict(wrate=wrate, steps=250, finetune_steps=250, early_stop=0.0)
    jep = jfit.fit_ctx_predictor(jspec, lat, log=lambda m: None, **fit_kw)
    logs = []
    tep = tfit.fit_ctx_predictor(tspec, lat, "cpu", log=logs.append, **fit_kw)
    assert any("phase 2 (q2 STE, 250 steps) chunk 1/1" in m for m in logs)
    assert any("500 steps in" in m for m in logs)
    jbits, tbits = _jax_bits(jspec, jep, lat), _jax_bits(jspec, tep, lat)
    start = _jax_bits(jspec, JM.ctx_feature_init(jspec), lat)
    marginal = _marginal_bits(lat)
    assert abs(tbits - jbits) <= 0.25 * jbits, (tbits, jbits)
    assert tbits < 0.85 * marginal and jbits < 0.85 * marginal, (tbits, jbits, marginal)
    assert tbits < 0.8 * start
    for n in JM.CTX_KERNELS:
        assert tep[n]["kernel"].shape == tspec.specs[n].kernel_shape and tep[n]["kernel"].dtype == np.float32


def test_fit_keywords_hold_to_the_jax_fit():
    """The JAX function's keywords: a warm start (``init_entropy``, the
    feature init plus seeded noise), the payload at half weight, another
    finetune lr; held to the JAX fit from the same start at the tolerance
    above. Then a port fit starts from the warm start's bits, and
    ``early_stop_patience`` 1 stops a phase at its second chunk (every
    chunk counts as flat at ``early_stop`` 1.0; the default 2 would not)."""
    kw = dict(entropy_mode="ctx_ar", ctx_hidden=8, ctx_tail=3)
    jspec, tspec = JM.build_model_spec(CH, CHANNELS, **kw), TM.build_model_spec(CH, CHANNELS, **kw)
    lat = _structured_latents()
    rng = np.random.default_rng(5)
    init = {n: {k: (np.asarray(v) + rng.normal(0, 0.02, np.shape(v))).astype(np.float32) for k, v in leaf.items()}
            for n, leaf in JM.ctx_feature_init(jspec).items()}
    wrate = {"sigma": np.asarray([0.5], np.float32), "mu": np.asarray([0.0], np.float32)}
    fit_kw = dict(wrate=wrate, steps=250, finetune_steps=250, finetune_lr=5e-3, payload_weight=0.5,
                  init_entropy=init, early_stop=0.0)
    jep = jfit.fit_ctx_predictor(jspec, lat, log=lambda m: None, **fit_kw)
    tep = tfit.fit_ctx_predictor(tspec, lat, "cpu", log=lambda m: None, **fit_kw)
    jbits, tbits = _jax_bits(jspec, jep, lat), _jax_bits(jspec, tep, lat)
    start = _jax_bits(jspec, init, lat)
    assert abs(tbits - jbits) <= 0.25 * jbits, (tbits, jbits)
    assert tbits < 0.85 * _marginal_bits(lat) and tbits < 0.8 * start, (tbits, start)
    # the warm start is where the port begins: its first logged bits are the start's
    logs = []
    tfit.fit_ctx_predictor(tspec, lat[:16], "cpu", steps=500, finetune_steps=0, init_entropy=init,
                           early_stop=1.0, early_stop_patience=1, log=logs.append)
    assert round(float(logs[0].split("start ")[1].split()[0])) == round(_jax_bits(jspec, init, lat[:16]))
    assert any("converged at chunk 2/2 (1 chunks" in m for m in logs), logs


def test_early_stop_and_short_fits_run_whole_chunks():
    """early_stop=1.0 makes every chunk count as flat: with patience 2 each
    phase stops at its third chunk; a 100-step phase still runs one whole
    250-step chunk (n_chunks = max(1, steps // 250), as the JAX package)."""
    spec = TM.build_model_spec(CH, CHANNELS, entropy_mode="ctx")
    lat = _structured_latents(n=16)
    logs = []
    tfit.fit_ctx_predictor(spec, lat, "cpu", steps=1500, finetune_steps=1500, early_stop=1.0,
                           log=logs.append)
    assert len([m for m in logs if "converged at chunk 3/6" in m]) == 2, logs
    logs = []
    tfit.fit_ctx_predictor(spec, lat, "cpu", steps=100, finetune_steps=0, log=logs.append)
    assert any("chunk 1/1" in m for m in logs) and any("250 steps in" in m for m in logs)
    with pytest.raises(ValueError, match="ctx-mode"):
        tfit.fit_ctx_predictor(TM.build_model_spec(CH, CHANNELS), lat, "cpu")


def test_upgrade_keeps_the_reconstruction_and_latents_equal_jax():
    jspec = JM.build_model_spec(CH, CHANNELS, entropy_mode="ctx")
    tspec = TM.build_model_spec(CH, CHANNELS, entropy_mode="ctx")
    import jax

    tree = jax.tree_util.tree_map(np.asarray, JM.init_params(jspec))
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map(lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(np.float32), tree)
    emb = rng.normal(0, 4, (7, 2, 2, 2, CH)).astype(np.float32)
    np.testing.assert_array_equal(tfit.latents_from_checkpoint(tspec, tree, emb, "cpu"),
                                  jfit.latents_from_checkpoint(jspec, tree, emb))
    out = tfit.upgrade_params_to_ctx(tspec, tree, emb, "cpu", steps=250, early_stop=1.0, log=lambda m: None)
    assert out["decoder"] is tree["decoder"] and out["latent_gen"] is tree["latent_gen"]
    assert set(out["entropy"]) == set(JM.CTX_KERNELS)


# ------------------------------------------------------- auto at encode time


def _resolved(cli, encode_mod, fit_mod, argv, monkeypatch, n_blocks):
    """(entropy_mode, ctx_hidden, ctx_tail, ctx_post ran) and the printed
    line of one package's ``encode`` up to the codec (which is stubbed)."""
    fake = {"origins": np.zeros((n_blocks, 3), np.int64), "gt": np.ones((n_blocks, 1)), "dist": None}
    monkeypatch.setattr(cli, "load_or_build_artifacts", lambda *a, **k: fake)
    seen = {"post": False}

    def fake_fit(spec, params, emb, *a, **k):
        seen["post"] = True
        return params

    class Stop(Exception):
        pass

    def fake_encode(params, emb, origins, mcfg, *a, **k):
        seen["cfg"] = (mcfg.entropy_mode, mcfg.ctx_hidden, mcfg.ctx_tail)
        raise Stop

    monkeypatch.setattr(fit_mod, "upgrade_params_to_ctx", fake_fit)
    monkeypatch.setattr(encode_mod, "encode", fake_encode)
    args = cli.build_parser().parse_args(argv)
    with pytest.raises(Stop):
        args.fn(args)
    return seen["cfg"] + (seen["post"],)


@pytest.mark.parametrize("case", [
    # (trained mode, trained tail, blocks, extra flags)
    ("ctx", 0, 5326, []),  # vox11: auto -> ctx_ar + ctx_post h32t24
    ("ctx", 0, 964, []),  # vox10-sized: break-even not met -> plain ctx
    ("channel", 0, 5326, []),  # channel checkpoints never upgrade
    ("ctx", 0, 5326, ["--ctx_post"]),  # ROADMAP section C: the checkpoint's tail stays
    ("ctx_ar", 3, 964, []),  # the checkpoint's tail split stays
    ("ctx", 0, 964, ["--entropy_mode", "ctx_ar", "--ctx_post", "--ctx_hidden", "32", "--ctx_tail", "24"]),
])
def test_encode_auto_resolves_as_the_jax_cli(case, tmp_path, monkeypatch, capsys):
    import nvfpcc_tpu.codec as jax_codec
    import nvfpcc_tpu_torch.codec as port_codec

    mode, tail, n_blocks, extra = case
    meta = {"ch": 3, "chanstr": "8,16,8,8", "entropy_mode": mode, "ctx_hidden": 8, "ctx_tail": tail}
    ckpt = jax_save_checkpoint(str(tmp_path), 0, {"decoder": {"x": np.zeros(1, np.float32)}}, np.ones((n_blocks, 2, 2, 2, 3), np.float32),
                               meta=meta)
    argv = ["encode", "c.ply", "--load_checkpoint", ckpt, "--platform", "cpu"] + extra
    want = _resolved(jax_cli, jax_codec, jfit, argv, monkeypatch, n_blocks)
    jout = capsys.readouterr().out
    got = _resolved(port_cli, port_codec, tfit, argv, monkeypatch, n_blocks)
    out = capsys.readouterr().out
    assert got == want
    if extra == ["--ctx_post"]:
        # the same pack as the JAX package (h32, the checkpoint's tail 0), and
        # a message that says why, where the JAX one says "not met"
        assert got == ("ctx_ar", 32, 0, True) and "break-even not met" in jout
        assert "explicit --ctx_post keeps tail 0" in out and "not met" not in out
    elif case == ("ctx", 0, 5326, []):
        assert got == ("ctx_ar", 32, 24, True) and "ctx_ar + ctx_post (hidden 32 tail 24)" in out
    elif case == ("ctx", 0, 964, []):
        assert got == ("ctx", 8, 0, False) and "break-even not met at 23136 symbols" in out


# --------------------------------------------------------- the CLI ctx drive


def test_ctx_train_encode_ctx_post_decode_through_the_cli(tmp_path, capsys):
    """ctx training (one q=1, one q=2 epoch), then two packs from the one
    checkpoint: `auto` (below break-even: the co-trained ctx predictor) and
    an explicit ctx_ar --ctx_post fit with tail units; each decodes (once
    through `serve`) to a cloud byte-equal to the encoder's. Then `weights`
    on the ctx checkpoint."""
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 2 * np.pi, 2000)
    pts = np.unique(np.clip(np.rint(np.stack(
        [64 + 40 * np.cos(t), 64 + 40 * np.sin(t), 64 + 20 * np.sin(2 * t)], -1)), 0, 127).astype(np.int64), axis=0)
    cloud = str(tmp_path / "toy.ply")
    write_ply_points(cloud, pts)
    toy = ["--depth", "7", "--level", "2", "--platform", "cpu"]
    ckpt = str(tmp_path / "ckpt")
    assert port_cli.main(["train", cloud, "--epochs", "2", "--phase_change", "1", "--eval_every", "1",
                          "--batchsize", "4", "--checkpoint_dir", ckpt, "--entropy_mode", "ctx",
                          "--ch", "2", "--chanstr", "4,8,4,4"] + toy) == 0
    assert capsys.readouterr().out.count(" TRAIN ") == 2
    runs = {"auto": [], "post": ["--entropy_mode", "ctx_ar", "--ctx_post", "--ctx_hidden", "8",
                                 "--ctx_tail", "3", "--ctx_fit_steps", "250"]}
    for name, flags in runs.items():
        pack, enc, dec = (str(tmp_path / f"{name}_{x}") for x in ("pack.pk", "rc_enc.ply", "rc_dec.ply"))
        assert port_cli.main(["encode", cloud, "--load_checkpoint", ckpt, "--pack_fn", pack, "--recon", enc,
                              "--thh", "0.3"] + flags + toy) == 0
        out = capsys.readouterr().out
        assert "ctx payload" in out
        if name == "auto":
            assert "entropy_mode auto -> ctx (from checkpoint; ctx_post break-even not met" in out
            assert handle({"cmd": "decode", "args": [pack, "--recon", dec, "--platform", "cpu"]}) == {
                "ok": True, "status": 0}
        else:
            assert "ctx_post fit on cpu" in out and "[ctx_fit] ctx_ar hidden=8" in out
            assert port_cli.main(["decode", pack, "--recon", dec, "--platform", "cpu"]) == 0
        with open(enc, "rb") as a, open(dec, "rb") as b:
            assert a.read() == b.read()
        assert len(read_ply_points(dec)) > 0
    from nvfpcc_tpu_torch.codec import load_pack

    modes = [load_pack(str(tmp_path / f"{n}_pack.pk"))["model"] for n in runs]
    assert modes[0]["entropy_mode"] == "ctx" and "ctx_tail" not in modes[0]
    assert modes[1]["entropy_mode"] == "ctx_ar" and modes[1]["ctx_tail"] == 3
    capsys.readouterr()
    assert port_cli.main(["weights", os.path.join(ckpt, "0001.npz")]) == 0
    assert "lossless round-trip OK" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # the fit's device is the encode's or the host's, nothing else
        port_cli.build_parser().parse_args(["encode", cloud, "--load_checkpoint", ckpt, "--ctx_fit_backend", "tpu"])
