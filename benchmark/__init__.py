"""The benchmark of ``nvfpcc_tpu_torch``: ``python3 -m benchmark.run``
(see ``benchmark/README.md``)."""
