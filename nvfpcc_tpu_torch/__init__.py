"""nvfpcc_tpu_torch — the NVF point-cloud geometry codec in PyTorch + CUDA.

The port of ``nvfpcc_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It
mirrors the reference package's layout so each module has a counterpart:

- ``ops``      — STE rounding/bounds, GDN/IGDN, the channel rate model,
  seeded quantization-aware convs (``nn.Module``s over cuDNN convs).
- ``models``   — latent generator, channel entropy bottleneck, CompDecoder.
- ``kernels``  — the hand-written CUDA kernels (``csrc/*.cu``), built with
  ``nvcc`` at first use and bound with ``ctypes``, each beside its plain
  PyTorch version.
- ``grids``    — occupancy + exact distance grids on the EDT kernel.
- ``metrics``  — D1 PSNR on the same EDT.
- ``codec``    — weight quantize/pack, encode/decode, the pack container.
- ``utils``    — params <-> numpy trees, npz checkpoints.
- ``cli`` / ``serve`` — ``grids | encode | decode | eval`` and the JSON-lines
  server.
- ``coder``, ``octree``, ``io``, ``config``, ``utils.seeds`` — copies of the
  JAX package's jax-free format modules (range coder, Huffman, octree, PLY,
  configs, the seed stream), held byte-equal to the originals by
  ``tests/test_torch_shared_copies.py``, so the two packages read and write
  the same packs and checkpoints.

Nothing here imports jax or ``nvfpcc_tpu``.
"""

__version__ = "0.1.0"
