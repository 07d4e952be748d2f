"""The port's single-card forward check (``nvfpcc_tpu_torch/tools/entry.py``)
against ``__graft_entry__.entry``: with the JAX params carried across, the
port's ``fn`` on the first 8 flagship embeddings equals ``jax.jit(fn)`` on
the CPU. Tolerances, set from f32 and the measured gaps (1.2e-7 on the
occupancy, 4.6e-7 relative on the net bits, 1.6e-6 relative on the latent
bit sum): occupancy atol 1e-6 + rtol 1e-5, net bits rtol 1e-5, the latent
bit sum rtol 1e-5."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as G
from nvfpcc_tpu_torch.tools import entry as E
from nvfpcc_tpu_torch.utils.params import params_from_numpy
from torch_train_helpers import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def both():
    """(JAX outputs, port outputs) of the eval forward on emb[:8]."""
    jfn, (jparams, jemb) = G.entry()
    want = [np.asarray(a) for a in jax.jit(jfn)(jparams, jemb[:8])]
    fn, (net, emb) = E.entry("cpu")
    params_from_numpy(net, jax.tree_util.tree_map(np.asarray, jparams))
    assert np.array_equal(emb.numpy(), np.asarray(jemb))
    got = [t.numpy() for t in fn(net, emb[:8])]
    return want, got, (net, emb)


def test_occupancy_equals_jax(both):
    want, got, _ = both
    assert got[0].shape == want[0].shape == (8, 32, 32, 32, 1)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-6)


def test_net_bits_equal_jax(both):
    want, got, _ = both
    assert got[1].shape == want[1].shape == (7,)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_latent_bit_sum_equals_jax(both):
    want, got, _ = both
    assert got[2].shape == want[2].shape == ()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5)


def test_entry_shapes_and_no_grad(both):
    """917 flagship embeddings (ch=3), the flagship decoder, and a forward
    that records no graph."""
    _, _, (net, emb) = both
    assert emb.shape == (917, 2, 2, 2, 3) and emb.dtype == torch.float32
    assert net.spec.ch == 3 and net.spec.channels == (8, 16, 8, 8)
    fn, _ = E.entry("cpu")
    out, net_bits, lat = fn(net, emb[:2])
    assert not (out.requires_grad or net_bits.requires_grad or lat.requires_grad)


def test_entry_runs_on_the_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        E.entry()
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        E.main([])
