"""The whole ``PureMultiInterFormer`` vs the JAX model (Pallas kernels in
interpret mode) on ``tiny_test_config(5)``, float32.

Tolerance: atol 1e-5 / rtol 1e-4 on the heatmaps (f32, two frameworks'
conv/matmul orders). Padded persons' heatmaps are exactly 0 on both sides.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_bridge import port_model, random_variables, tiny_jax_model

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def models():
    cfg, jmodel = tiny_jax_model(use_pallas=True)
    variables = random_variables(jmodel, cfg, seed=2)
    fwd = jax.jit(lambda im, pm, pv: jmodel.apply(variables, im, pm, pv, train=False)["multi"])
    return fwd, port_model(variables, cfg)


def _inputs(rng, valid):
    b, n = valid.shape
    images = rng.randn(b, n, 64, 48, 3).astype(np.float32)
    pos = rng.rand(b, n, 64, 48, 1).astype(np.float32)
    return images, pos, valid


@pytest.mark.parametrize("valid", [
    np.ones((2, 3), bool),                                 # uniform person counts
    np.array([[1, 1, 1], [1, 0, 0], [0, 0, 0]], bool),     # ragged + a fully padded image
], ids=["uniform", "ragged"])
def test_pure_multi_matches_jax(models, rng, valid):
    fwd, model = models
    images, pos, valid = _inputs(rng, valid)
    ref = np.asarray(fwd(images, pos, valid))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, (images, pos, valid))).numpy()
    assert got.shape == (*valid.shape, 5, 16, 12) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(ref).max() > 0.05  # the comparison is of O(1) heatmaps
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert not got[~valid].any() and not ref[~valid].any()


def test_kernel_flag_on_cpu_is_the_plain_path(models, rng):
    """use_kernels routes through the kernel wrappers, which take the plain
    versions for CPU tensors: identical heatmaps, no launches counted."""
    from i2rnet_tpu_torch.ops.cuda import KERNELS, launch_counts, reset_launches

    _, model = models
    args = list(map(torch.from_numpy, _inputs(rng, np.array([[1, 1, 0]], bool))))
    reset_launches()
    with torch.no_grad():
        off = model(*args)
        model.global_encoder.use_kernels = True
        try:
            on = model(*args)
        finally:
            model.global_encoder.use_kernels = False
    assert torch.equal(on, off)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_bfloat16_compute_dtype(models, rng):
    """COMPUTE_DTYPE bfloat16 (the recipe's) casts weights at use and keeps
    the BN fold's [C] math in f32: finite heatmaps close to float32's
    (bf16 keeps ~3 decimal digits: 5% of the heatmap range)."""
    _, model = models
    args = list(map(torch.from_numpy, _inputs(rng, np.array([[1, 1, 0]], bool))))
    with torch.no_grad():
        ref = model(*args)
        model.compute_dtype = torch.bfloat16
        try:
            got = model(*args)
        finally:
            model.compute_dtype = torch.float32
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert not got[0, 2].any()
    assert (got - ref).abs().max() <= 0.05 * ref.abs().max()
