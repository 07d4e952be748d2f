"""Model and codec configuration (copy of ``ModelConfig`` and ``CodecConfig``
from ``nvfpcc_tpu/config.py``, defaults unchanged; held equal by
``tests/test_torch_shared_copies.py``).

Mirrors the reference's flag surface (``NVFPCC.py:654-748``). ``TrainConfig``
comes with the training port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class ModelConfig:
    ch: int = 3  # latent channels (--ch; README uses 3)
    chanstr: str = "8,16,8,8"  # decoder channel plan (--chanstr)
    seed_tag: str = "nvfpcc-tpu/seed-stream/v1"
    entropy_mode: str = "channel"
    """Latent entropy model granularity: "channel" = one (sigma, mu) per
    latent channel (the reference's active QuantGaussianLikelihood,
    utils/network.py:4490-4552); "spatio" = one per latent position
    (2,2,2,ch) (the dormant SpatioQuantGaussianLikelihood design,
    utils/network.py:4554-4590, with its self.bypass_round bug fixed);
    "ctx"/"ctx_ar" = autoregressive masked-conv context prediction;
    "gmm"/"factorized" = richer non-contextual models."""

    ctx_detach_pred: bool = False
    """ctx modes, training-only: stop the rate gradient at the context
    predictor's input (see ModelSpec.ctx_detach_pred). Does not affect the
    pack format."""

    ctx_hidden: int = 8
    """ctx modes: masked-conv predictor hidden width (8 matches the reference
    PredNet, utils/network.py:4385-4388). Travels in the pack model metadata
    (model.ctx_hidden) since the decoder must rebuild the same predictor."""

    ctx_tail: int = 0
    """ctx_ar only: the last ``ctx_tail`` of the ``ctx_hidden`` predictor
    units are payload-cheap tail units — full causal ctx1 taps, but readable
    by ctx2 only through the channel-gated center tap (~1/7 the transmitted
    taps per unit; see models.decoder.ModelSpec.ctx_tail). Format-visible:
    travels in the pack model metadata (absent = 0 keeps older packs
    decodable) and in checkpoint metadata."""

    ctx_train_init: str = "zero"
    """ctx modes, training-only (never format-relevant — the pack carries
    whatever kernels come out): predictor init for CO-TRAINING. "zero" is the
    reference behavior and the measured RD default — its optimization
    deadlock (the predictor learns sigma but never mu) is load-bearing: the
    big co-trained rate cuts come from the rate gradient warping latents
    toward predictability, and a WORKING predictor removes that pressure
    (RESULTS.md round 3, E1/E3). "feature" starts from the pass-through
    feature init instead (models.decoder.ctx_feature_init) — measured worse
    for co-training, kept for the decision artifact and for experimentation;
    it is the default for POST-HOC fits (train/ctx_fit.py), where it wins."""

    @property
    def channels(self) -> Tuple[int, ...]:
        return tuple(int(c) for c in self.chanstr.split(","))


@dataclass
class CodecConfig:
    thh_encode: float = 0.65  # README:55
    thh_decode: float = 0.64  # README:61
    qp: int = 16  # weight quantization (README "4-bit" residuals)
    depth: int = 10  # vox10
    level: int = 5  # octree partition level -> 32^3 blocks
    recon_dtype: str = "f32"
    """Reconstruction dtype, "f32" or "bf16". bf16 runs the decode chain on
    the MXU's native precision (measured 1.30x on one v5e chip with ~0.8% of
    thresholded voxels flipping — RESULTS.md); it rides in the pack so both
    sides run the identical program and rc_enc == rc_dec stays structural."""
