"""nvfpcc_tpu_torch — the NVF point-cloud geometry codec in PyTorch + CUDA.

The port of ``nvfpcc_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. It
mirrors the reference package's layout so each module has a counterpart:

- ``ops``      — STE rounding/bounds, GDN/IGDN, the latent and weight rate
  models, seeded quantization-aware convs (``nn.Module``s over cuDNN convs).
- ``models``   — latent generator, the entropy modes' bottlenecks (channel,
  spatio, gmm, factorized; the masked-conv context predictor of ctx and
  ctx_ar), CompDecoder, f32 or bf16 reconstruction.
- ``train``    — losses and metrics, the RD objective, the epoch (per-batch
  net steps + the full-set embedding update), ``train()`` in one process or
  as one rank of a block-DP group; ``train/ctx_fit.py`` fits the context
  predictor post hoc (``encode --ctx_post``).
- ``parallel`` — block-data-parallel training over ``torch.distributed``:
  the padded block axis split into per-rank rows, decoder gradients summed
  by all-reduce, a group started in-process or under ``torchrun``.
- ``kernels``  — the hand-written CUDA kernels (``csrc/*.cu``), built with
  ``nvcc`` at first use and bound with ``ctypes``, each beside its plain
  PyTorch version.
- ``grids``    — occupancy + exact distance grids on the EDT kernel.
- ``metrics``  — D1 PSNR on the same EDT (``metrics/d1.py``) and the
  point-to-plane D2 PSNR (``metrics/d2.py``).
- ``codec``    — weight quantize/pack, encode/decode, the pack container.
- ``utils``    — params and Adam state <-> numpy trees, npz checkpoints
  and train-state snapshots, the native-library build.
- ``cli`` / ``serve`` — ``grids | train | encode | decode | eval | weights``
  and the JSON-lines server; ``device`` resolves ``--platform`` and pins the
  numerics of reconstruction and of training.
- ``tools``    — the README's workflow scripts (``rd_sweep``: bpp against D1
  over lambda x threshold; ``encode_eval``: re-encode and score a
  checkpoint; ``pipeline_demo``: grids -> train -> encode -> decode in one
  warm process against the 10-minute target), the repo's headline bench
  (``bench``: the flagship training epoch, warm encode and decode) and
  single-card forward check (``entry``), measurement scripts for the card
  (EDT kernel A/B, where a training epoch's time goes, the ctx recipe) and
  the CPU block-DP dry run.
- ``coder``, ``octree``, ``io``, ``config``, ``utils.seeds`` — copies of the
  JAX package's jax-free format modules (range coder, Huffman, the context
  coder ``coder/ctx_coder.py``, octree, PLY, configs, the seed stream), held
  byte-equal to the originals by ``tests/test_torch_shared_copies.py``, so
  the two packages read and write the same packs and checkpoints.

Nothing here imports jax or ``nvfpcc_tpu``.
"""

__version__ = "0.1.0"
