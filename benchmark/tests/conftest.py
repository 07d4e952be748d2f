"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from
the repo's root. They run on the CPU at small sizes; the ones marked
``cuda`` need a card and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def short_ctx_fits(monkeypatch):
    """The ctx predictor's fits cut to 250 + 250 steps (the card runs the
    program's defaults; on the CPU a default fit takes about 25 s)."""
    from nvfpcc_tpu_torch.train import ctx_fit

    fit = ctx_fit.fit_ctx_predictor
    monkeypatch.setattr(ctx_fit, "fit_ctx_predictor",
                        lambda *a, **kw: fit(*a, **{**kw, "steps": 250, "finetune_steps": 250}))
