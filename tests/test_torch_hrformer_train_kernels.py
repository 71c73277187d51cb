"""Kernel 9 on the CPU: the plain version vs the JAX Pallas kernel it replaces.

``window_attn_block_train_torch`` (forward, and autograd for the backward)
against ``i2rnet_tpu/ops/pallas/hrformer_block_train.py::
window_attn_block_train`` in interpret mode (its Pallas forward and its two
Pallas backward kernels through ``jax.vjp``), on the same numpy inputs:
LayerNorm and projections in flax layouts on the JAX side, torch ``Linear``
layouts on the port's. Maps 9x8 (2 heads) and 16x12 (3 heads, head dim 8)
both pad to the 7-grid; the droppath scales include a 0.

Tolerances: float32 forward atol 1e-5 / rtol 1e-4; float32 gradients within
1e-4 of each tensor's largest magnitude (two f32 summation orders). In
bfloat16 both forwards round at the same points; the backwards do not
(autograd rounds the gradients where the forward casts, the Pallas kernels
round ``dS`` and keep ``dP`` in f32), so the forward and every gradient are
held within 2e-2 of the tensor's largest magnitude. ``dbk`` is 0 in exact
arithmetic (softmax ignores a bias shared by every key), so it is held
against the scale of ``dbq`` instead of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2rnet_tpu.ops.pallas.hrformer_block_train import window_attn_block_train
from i2rnet_tpu_torch.ops.cuda import KERNELS, build, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (window_attn_block_train_fused,
                                                            window_attn_block_train_torch)

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
GRAD_REL = {np.float32: 1e-4, "bfloat16": 2e-2}
NAMES = ("x", "ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
T = torch.from_numpy


def _params(rng, c):
    """LN1 scale/bias and flax-layout projections ([in, out]) with biases."""
    f = lambda: (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)  # noqa: E731
    b = lambda: (0.1 * rng.randn(c)).astype(np.float32)  # noqa: E731
    return [rng.uniform(0.5, 1.5, c).astype(np.float32), b(), f(), b(), f(), b(), f(), b(), f(),
            b()]


def _to_torch(prm):
    """The port's layouts: Linear weights [out, in]."""
    return [T(np.ascontiguousarray(p.T)) if p.ndim == 2 else T(p) for p in prm]


def _rel(got, ref, scale=None):
    scale = np.abs(ref).max() if scale is None else scale
    return np.abs(got - ref).max() / max(scale, 1e-30)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("p,h,w,c,heads", [(3, 9, 8, 16, 2), (2, 16, 12, 24, 3)])
def test_plain_matches_pallas_forward_and_grads(rng, p, h, w, c, heads, dtype):
    x = (rng.rand(p, h, w, c) * 2 - 1).astype(np.float32)
    cot = rng.randn(p, h, w, c).astype(np.float32)
    s = np.array([1.25, 0.0, 1.0][:p], np.float32)
    prm = _params(rng, c)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype is np.float32
                else (jnp.bfloat16, torch.bfloat16))

    def jax_fn(x_, *prm_):
        return window_attn_block_train(x_, jnp.asarray(s), *prm_, heads=heads, interpret=True)

    ref, vjp = jax.vjp(jax_fn, jnp.asarray(x, jdt), *map(jnp.asarray, prm))
    jgrads = vjp(jnp.asarray(cot, jdt))
    ref = np.asarray(ref.astype(jnp.float32))

    xs = T(x).to(tdt).requires_grad_(True)
    ps = [t.requires_grad_(True) for t in _to_torch(prm)]
    out = window_attn_block_train_torch(xs, T(s), *ps, heads)
    tgrads = torch.autograd.grad(out, [xs, *ps], T(cot).to(tdt))
    got = out.detach().float().numpy()
    assert out.dtype == tdt
    np.testing.assert_array_equal(got[1], x[1] if dtype is np.float32
                                  else xs[1].detach().float().numpy())  # s = 0: x exactly
    if dtype is np.float32:
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    else:
        assert _rel(got, ref) <= GRAD_REL[dtype]

    scales = {}
    for name, a, r in zip(NAMES, tgrads, jgrads):
        a = a.float().numpy()
        r = np.asarray(r.astype(jnp.float32))
        if r.ndim == 2 and name != "x":
            r = r.T  # flax [in, out] -> torch [out, in]
        scales[name] = np.abs(r).max()
        scale = scales["bq"] if name == "bk" else None
        assert _rel(a, r, scale) <= GRAD_REL[dtype], (name, _rel(a, r, scale))
        if name == "x":  # s = 0: the gradient is the residual's, dy exactly
            np.testing.assert_array_equal(a[1], T(cot).to(tdt).float().numpy()[1])
    assert scales["bq"] > 1e-3 and scales["wq"] > 1e-3


def test_pad_tokens_reach_the_bias_gradients(rng):
    """Pad tokens are 0 after LN, but their q, k and v are the biases and
    they are attended to, so the value-bias gradient sums dV over every key,
    pad keys included: since each row of P sums to 1 it is exactly
    ``(sum over real tokens of s * dy) . Wo``. On a 7x6 map (a pad column in
    each window) the plain version and JAX both give that."""
    x = (rng.rand(2, 7, 6, 16) * 2 - 1).astype(np.float32)
    cot = rng.randn(2, 7, 6, 16).astype(np.float32)
    s = np.array([1.25, 0.5], np.float32)
    prm = _params(rng, 16)
    want = (s[:, None, None, None] * cot).sum((0, 1, 2)) @ prm[8].T  # flax wo [in, out]

    ps = [t.requires_grad_(True) for t in _to_torch(prm)]
    out = window_attn_block_train_torch(T(x), T(s), *ps, 2)
    dbv = torch.autograd.grad(out, ps[7], T(cot))[0].numpy()
    np.testing.assert_allclose(dbv, want, rtol=1e-4, atol=1e-5)

    def jax_fn(bv):
        args = [jnp.asarray(p) for p in prm]
        args[7] = bv
        return window_attn_block_train(jnp.asarray(x), jnp.asarray(s), *args, heads=2,
                                       interpret=True)

    _, vjp = jax.vjp(jax_fn, jnp.asarray(prm[7]))
    np.testing.assert_allclose(np.asarray(vjp(jnp.asarray(cot))[0]), want, rtol=1e-4, atol=1e-5)


def test_dropped_sample_adds_nothing(rng):
    """A sample with s = 0 contributes nothing to any parameter gradient: the
    same as the batch without it (its dx is dy, held above)."""
    x = T((rng.rand(3, 9, 8, 16) * 2 - 1).astype(np.float32))
    cot = T(rng.randn(3, 9, 8, 16).astype(np.float32))
    prm = _to_torch(_params(rng, 16))

    def grads(xs, s, dy):
        ps = [t.clone().requires_grad_(True) for t in prm]
        return torch.autograd.grad(window_attn_block_train_torch(xs, s, *ps, 2), ps, dy)

    with_dropped = grads(x, torch.tensor([1.25, 0.0, 1.25]), cot)
    without = grads(x[[0, 2]], torch.tensor([1.25, 1.25]), cot[[0, 2]])
    for name, a, b in zip(NAMES[1:], with_dropped, without):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


def test_wrapper_takes_plain_path_on_cpu(rng):
    """On CPU tensors the wrapper is the plain version, gradients included;
    no launch is counted."""
    reset_launches()
    x = T((rng.rand(2, 9, 8, 16) * 2 - 1).astype(np.float32))
    prm = _to_torch(_params(rng, 16))
    s = torch.tensor([1.25, 0.0])
    ps1 = [t.clone().requires_grad_(True) for t in prm]
    ps2 = [t.clone().requires_grad_(True) for t in prm]
    a = window_attn_block_train_fused(x, s, *ps1, heads=2)
    b = window_attn_block_train_torch(x, s, *ps2, 2)
    assert torch.equal(a, b)
    a.sum().backward()
    b.sum().backward()
    for p1, p2 in zip(ps1, ps2):
        assert torch.equal(p1.grad, p2.grad)
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_wrapper_refuses_other_devices_and_shapes():
    """Off the CPU the wrapper launches or raises: shapes the kernels do not
    take are refused first, then any device but CUDA."""
    w = torch.empty(16, 16, device="meta")
    x = torch.empty(2, 7, 7, 16, device="meta")
    args = (None, None, w, None, w, None, w, None, w, None)
    with pytest.raises(ValueError, match="unsupported device"):
        window_attn_block_train_fused(x, torch.ones(2), *args, heads=2)
    with pytest.raises(ValueError, match="window 5"):
        window_attn_block_train_fused(x, torch.ones(2), *args, heads=2, window=5)
    with pytest.raises(ValueError, match="3 heads"):
        window_attn_block_train_fused(x, torch.ones(2), *args, heads=3)
    with pytest.raises(ValueError, match=r"\[C, C\]"):
        window_attn_block_train_fused(x, torch.ones(2), *args[:8], torch.empty(8, 16), None,
                                      heads=2)
    with pytest.raises(ValueError, match="s must be"):
        window_attn_block_train_fused(x, torch.ones(3), *args, heads=2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        window_attn_block_train_fused(x.half(), torch.ones(2), *args, heads=2)


def test_signatures_cover_the_new_entry_points():
    assert {"i2r_window_attn_train_fwd", "i2r_window_attn_train_bwd"} <= set(build.SIGNATURES)
    assert {"window_attn_block_train_fwd", "window_attn_block_train_bwd"} <= set(KERNELS)
