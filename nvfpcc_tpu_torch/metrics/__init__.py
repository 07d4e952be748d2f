"""Reconstruction quality metrics: D1 (point-to-point) and D2
(point-to-plane) PSNR."""

from nvfpcc_tpu_torch.metrics.d1 import d1_psnr  # noqa: F401
from nvfpcc_tpu_torch.metrics.d2 import d2_psnr, estimate_normals, nn_vectors  # noqa: F401
