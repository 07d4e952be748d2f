"""The port's ctx decoder (``coder/ctx_steps.py``) against the shared host
coder it stands in for (``coder/ctx_coder.py``): each step's predictions
equal ``ExactPredictor``'s, past the float64 bound too; a plan that would
read an undecoded latent is refused; a stream the shared encoder wrote
decodes to the same latents through either decoder, again from the
process's tables, which are the coder's.
"""

import numpy as np
import pytest

from nvfpcc_tpu_torch.coder import ctx_coder as CTX
from nvfpcc_tpu_torch.coder import ctx_steps as CS
from nvfpcc_tpu_torch.models import decoder as M

# (entropy mode, ch, hidden, tail): the vox11 pack's, a toy ctx_ar, plain ctx
CASES = [("ctx_ar", 3, 32, 24), ("ctx_ar", 2, 8, 4), ("ctx", 3, 16, 0)]


def ints_for(mode, ch, hidden, tail, seed, scale=0.3):
    """A pack's predictor integers from seeded kernel residuals on the 1/16
    grid and seeded biases."""
    spec = M.build_model_spec(ch, entropy_mode=mode, ctx_hidden=hidden, ctx_tail=tail)
    rng = np.random.default_rng(seed)
    ent = {}
    for name, (cin, cout) in (("ctx1", (ch, hidden)), ("ctx2", (hidden, 2 * ch))):
        k = np.rint(rng.normal(0, scale, (3, 3, 3, cin, cout)) * 16) / 16
        ent[name] = {"kernel": k.astype(np.float32), "b": rng.normal(0, 0.5, cout).astype(np.float32)}
    return CTX.ctx_ints_from_payload(spec, CTX.build_ctx_payload(spec, ent, 16))


@pytest.mark.parametrize("mode,ch,hidden,tail", CASES)
def test_each_step_predicts_as_the_exact_predictor(mode, ch, hidden, tail):
    """Step by step on latents filled through the step before, each step's
    (mu16, sigma_idx) are ``ExactPredictor``'s at that step on those
    latents and on the full ones, exactly."""
    ints = ints_for(mode, ch, hidden, tail, seed=ch + hidden)
    rng = np.random.default_rng(1)
    lat = rng.integers(-40, 41, (50, 2, 2, 2, ch))
    full, step = CTX.ExactPredictor(ints), CS.StepPredictor(ints, ch, mode == "ctx_ar")
    x = np.zeros_like(lat)
    for z, y, w, csel in CTX._steps(ch, mode == "ctx_ar"):
        got = step(x)
        for xs in (x, lat):
            mu16, sidx = full(xs)
            np.testing.assert_array_equal(got[0], mu16[:, z, y, w, csel])
            np.testing.assert_array_equal(got[1], sidx[:, z, y, w, csel])
        x[:, z, y, w, csel] = lat[:, z, y, w, csel]


def test_past_the_float_bound_a_step_reads_the_full_predictor():
    """From the step whose latents make a layer-2 sum able to leave
    float64's exact integers, the steps take the exact predictor's."""
    ints = ints_for("ctx_ar", 3, 8, 4, seed=2)
    step = CS.StepPredictor(ints, 3, True)
    scale = 1
    while (scale * step._colsum1 + step._b1max) * step._colsum2 < (1 << 53):
        scale *= 2
    lat = np.random.default_rng(3).integers(-40, 41, (6, 2, 2, 2, 3))
    lat[0, 1, 0, 0, 1] = scale  # decoded at step 13
    full, calls = step._full, []
    step._full = lambda x: calls.append(1) or full(x)
    x = np.zeros_like(lat)
    for z, y, w, csel in CTX._steps(3, True):
        got = step(x)
        mu16, sidx = full(x)
        np.testing.assert_array_equal(got[0], mu16[:, z, y, w, csel])
        np.testing.assert_array_equal(got[1], sidx[:, z, y, w, csel])
        x[:, z, y, w, csel] = lat[:, z, y, w, csel]
    assert len(calls) == 24 - 14


def test_a_step_that_would_read_an_undecoded_latent_is_refused():
    """A layer-1 weight from a later latent into a hidden unit a step reads
    (no mask lets one through) is refused when the plan is made."""
    ints = ints_for("ctx_ar", 3, 8, 4, seed=5)
    ints["K1"] = ints["K1"].copy()
    ints["K1"][1, 1, 1, 2, 0] = 7  # channel 2 into unit 0 at the center
    with pytest.raises(ValueError, match="has not decoded"):
        CS.StepPredictor(ints, 3, True)


@pytest.mark.parametrize("mode,ch,hidden,tail", CASES)
def test_a_stream_decodes_as_the_shared_decoder_decodes_it(mode, ch, hidden, tail):
    """The shared encoder's stream (one residual beyond the alphabet, so
    clamped) decodes to its coded latents through both decoders."""
    ints = ints_for(mode, ch, hidden, tail, seed=7, scale=0.1)
    rng = np.random.default_rng(4)
    lat = np.rint(rng.normal(3, 9, (120, 2, 2, 2, ch))).astype(np.int64)
    lat[5, 1, 0, 1, -1] = 900
    ar = mode == "ctx_ar"
    enc = CTX.encode_latents_ctx(lat, ints, ar)
    assert enc["n_clamped"] >= 1
    ours = CS.decode_latents_ctx(enc["stream"], enc["shape"], ints, ar)
    np.testing.assert_array_equal(ours, enc["coded"])
    np.testing.assert_array_equal(ours, CTX.decode_latents_ctx(enc["stream"], enc["shape"], ints, ar))
    again = CS.decode_latents_ctx(enc["stream"], enc["shape"], ints, ar)  # from the process's tables
    np.testing.assert_array_equal(again, ours)


def test_the_process_tables_are_the_coders_tables():
    """Every row the decoders built is ``ctx_coder``'s table of its key,
    and row 0 is built."""
    test_a_stream_decodes_as_the_shared_decoder_decodes_it("ctx_ar", 2, 8, 4)
    built = np.flatnonzero(CS._TABLES["built"])
    assert 0 in built and len(built) > 1
    np.testing.assert_array_equal(CS._TABLES["cum"][built], CTX._tables_for_keys(built, {}))
