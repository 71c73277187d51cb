"""I²R-Net in PyTorch with hand-written CUDA kernels for Hopper.

The port of ``i2rnet_tpu`` (JAX/Pallas on TPU) to one NVIDIA H100: the same
module layout and names, PyTorch inside. It imports ``torch`` and never
``jax`` or ``i2rnet_tpu``. This slice is the vanilla I²R-Net serving path
(``interformer_pureMulti``): ``presets`` -> ``models.pure_multi`` ->
``serving.Predictor``, with the masked attention and the encoder FFN tail
running the kernels of ``csrc/`` (built by ``ops.cuda.build``).
"""
