"""Data parallelism across processes (:mod:`~i2rnet_tpu_torch.parallel.dist`)."""
