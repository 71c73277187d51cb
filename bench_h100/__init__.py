"""The benchmark of the PyTorch and CUDA port (``i2rnet_tpu_torch``) on one
NVIDIA H100: ``python3 -m bench_h100.run`` runs one cell of ``BENCHMARK.json``
(see ``README.md``)."""
