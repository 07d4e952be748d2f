"""Differentiable rate models (port of ``nvfpcc_tpu/ops/rate.py``).

- ``gaussian_bits`` / ``laplace_bits``: bits under a boxed CDF,
  ``-log2(CDF(x - mu + step/2) - CDF(x - mu - step/2))``, with a
  gradient-gated likelihood floor of 1e-8.
- ``gmm2_bits``: a per-channel 2-component Gaussian mixture.
- ``factorized_bits``: a per-channel monotone logit-CDF MLP (Balle-style),
  with the reference's sign trick and a 1e-9 floor.
- ``scalar_gaussian_rate``: the weight-residual rate, one learned
  ``(sigma, mu)`` Gaussian over a whole tensor at step 1/16.

All math is float32. Parameter trees are dicts of tensors under the JAX
package's leaf names.
"""

from __future__ import annotations

import math

import torch

from nvfpcc_tpu_torch.ops.ste import lower_bound

LIKELIHOOD_FLOOR = 1e-8
_LOG2 = math.log(2.0)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """Standard normal CDF with erfc in the tails (the formulation of
    ``jax.scipy.special.ndtr``; ``torch.special.ndtr`` loses the lower tail
    in float32 to cancellation)."""
    half_sqrt_2 = 0.5 * math.sqrt(2.0)
    w = x * half_sqrt_2
    z = torch.abs(w)
    tail = torch.where(w > 0, 2.0 - torch.special.erfc(z), torch.special.erfc(z))
    return 0.5 * torch.where(z < half_sqrt_2, 1.0 + torch.special.erf(w), tail)


def _boxed_likelihood_gaussian(x, sigma, mu, step):
    half = 0.5 * step
    return ndtr((x - mu + half) / sigma) - ndtr((x - mu - half) / sigma)


def _laplace_cdf(z):
    # Laplace(0, 1) CDF
    return torch.where(z < 0, 0.5 * torch.exp(z), 1.0 - 0.5 * torch.exp(-z))


def _bits_from_likelihood(likelihood):
    return -torch.log(lower_bound(likelihood, LIKELIHOOD_FLOOR)) / _LOG2


def gaussian_bits(x, sigma, mu, step: float = 1.0) -> torch.Tensor:
    """Per-element bits under N(mu, sigma) with quantization bin ``step``."""
    return _bits_from_likelihood(_boxed_likelihood_gaussian(x, sigma, mu, step))


def laplace_bits(x, sigma, mu, step: float = 1.0) -> torch.Tensor:
    """Per-element bits under Laplace(mu, sigma) with quantization bin ``step``."""
    half = 0.5 * step
    likelihood = _laplace_cdf((x - mu + half) / sigma) - _laplace_cdf((x - mu - half) / sigma)
    return _bits_from_likelihood(likelihood)


def laplace_rate(x, sigma, mu, step: float = 1.0) -> torch.Tensor:
    return laplace_bits(x, sigma, mu, step).sum()


def gmm2_init(ch: int) -> dict:
    """Per-channel 2-component mixture params: sigma 1, component means
    split at -/+0.5 (deterministic, so the init breaks the component
    symmetry without an RNG), mixing logit 0."""
    return {
        "sigma": torch.ones((2, ch), dtype=torch.float32),
        "mu": torch.stack([torch.full((ch,), -0.5), torch.full((ch,), 0.5)]).float(),
        "p_logit": torch.zeros((ch,), dtype=torch.float32),
    }


def gmm2_bits(x, params: dict, step: float = 1.0) -> torch.Tensor:
    """Per-element bits of channels-last ``x`` under the per-channel mixture
    ``p N(mu0, |sigma0|) + (1 - p) N(mu1, |sigma1|)``, ``p = sigmoid(p_logit)``."""
    sigma = torch.abs(params["sigma"])
    mu = params["mu"]
    p = torch.sigmoid(params["p_logit"])
    l0 = _boxed_likelihood_gaussian(x, sigma[0], mu[0], step)
    l1 = _boxed_likelihood_gaussian(x, sigma[1], mu[1], step)
    return _bits_from_likelihood(p * l0 + (1.0 - p) * l1)


FACTORIZED_FILTERS = (1, 3, 3, 3, 1)  # reference CDFModel.filters
_FACTORIZED_FLOOR = 1e-9  # reference LikelihoodModel likelihood bound


def factorized_init(ch: int, init_scale: float = 10.0) -> dict:
    """Per-channel logit-CDF MLP params: matrices at a constant scale, biases
    evenly spaced in (-0.5, 0.5) per unit (deterministic: entropy params
    ship in the pack), tanh-factor gates at zero."""
    f = FACTORIZED_FILTERS
    scale = init_scale ** (1.0 / (len(f) + 1))
    params = {}
    for i in range(len(f) - 1):
        params[f"matrix_{i}"] = torch.full((ch, f[i], f[i + 1]), scale, dtype=torch.float32)
        n = f[i + 1]
        b = (torch.arange(n, dtype=torch.float32) + 0.5) / n - 0.5
        params[f"bias_{i}"] = b.expand(ch, n).clone()
        if i < len(f) - 2:
            params[f"factor_{i}"] = torch.zeros((ch, f[i + 1]), dtype=torch.float32)
    return params


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``); ``F.softplus`` switches to the identity above
    ``threshold=20``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def factorized_logit_cdf(params: dict, x: torch.Tensor) -> torch.Tensor:
    """logit-CDF of ``x`` (..., ch) under each channel's MLP."""
    f = FACTORIZED_FILTERS
    y = x[..., None]  # (..., ch, 1)
    for i in range(len(f) - 1):
        m = softplus(params[f"matrix_{i}"])
        y = torch.einsum("...ci,cio->...co", y, m) + params[f"bias_{i}"]
        if i < len(f) - 2:
            y = y + torch.tanh(params[f"factor_{i}"]) * torch.tanh(y)
    return y[..., 0]


def factorized_bits(x, params: dict, step: float = 1.0) -> torch.Tensor:
    """Per-element bits under the factorized model. The sign trick (a
    constant ``-sign(upper + lower)``, no gradient) evaluates the far tail
    where the sigmoids do not saturate; ``sign = 0`` gives likelihood 0,
    which the floor lifts to 1e-9."""
    half = 0.5 * step
    upper = factorized_logit_cdf(params, x + half)
    lower = factorized_logit_cdf(params, x - half)
    sign = -torch.sign(upper + lower).detach()
    likelihood = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    return -torch.log(lower_bound(likelihood, _FACTORIZED_FLOOR)) / _LOG2


def scalar_gaussian_rate(params: dict, x: torch.Tensor, step: float = 1.0 / 16.0):
    """Total bits of tensor ``x`` under the scalar ``(sigma, mu)`` Gaussian."""
    sigma = torch.abs(params["sigma"])
    return gaussian_bits(x.reshape(-1), sigma, params["mu"], step).sum()
