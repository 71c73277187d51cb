"""The benchmark's plain reference: the models, the request math and the
training step of the benchmarked configurations, in plain PyTorch and numpy.

A frozen copy of the equations (reference repo ``lib/models``,
``lib/core/inference.py``, ``lib/utils/transforms.py``, ``lib/core/loss.py``;
the DETR encoder; Adam), computed in float32 with TF32 off. It imports
nothing of the program under test, ``jax`` or the JAX package: the benchmark
hands it the weights and inputs it made, and it recomputes every crop,
affine, mask, target and dropout bit itself.
"""
