"""The port's entry points: ``python3 -m i2rnet_tpu_torch.tools.train`` and
``python3 -m i2rnet_tpu_torch.tools.test``."""
