"""Kernels E, F, G and 7 on the CPU: their plain versions vs the JAX Pallas
kernels they replace (interpret mode) and the wrappers' CPU dispatch.

E is ``window_attn_block_fused``, F ``mlp_block_fused``, 7 ``full_block_fused``
(all ``i2rnet_tpu/ops/pallas/hrformer_block.py``), G ``mlp_dwbn_fused``
(``i2rnet_tpu/ops/pallas/mlp_dwbn.py``). The same numpy inputs go to both
sides; the MLP weights are BatchNorm-folded on each side by its own
``fold_bn`` from non-trivial statistics.

Tolerances: float32 atol 1e-5 / rtol 1e-4 (two f32 summation orders). In
bfloat16 both sides round at the same points, so an element differs only
where two f32 sums straddle a rounding boundary: by one bf16 step of the
value or of an intermediate carried through, bounded here by
``BF16_REL`` of the output's largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2rnet_tpu.ops.pallas.hrformer_block import full_block_fused as jax_full_block
from i2rnet_tpu.ops.pallas.hrformer_block import mlp_block_fused as jax_mlp_block
from i2rnet_tpu.ops.pallas.hrformer_block import window_attn_block_fused as jax_window_attn
from i2rnet_tpu.ops.pallas.mlp_dwbn import fold_bn as jax_fold_bn
from i2rnet_tpu.ops.pallas.mlp_dwbn import mlp_dwbn_fused as jax_mlp_dwbn
from i2rnet_tpu_torch.ops.cuda import KERNELS, build, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (full_block_fused, full_block_torch,
                                                      mlp_block_fused, mlp_block_torch,
                                                      window_attn_block_fused,
                                                      window_attn_block_torch)
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import fold_bn, mlp_dwbn_fused, mlp_dwbn_torch

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
BF16_REL = 2e-2
#: (P, H, W, C, heads): the JAX tests' three block shapes (18x13 and 7x6 pad
#: to the 7-grid, 14x14 does not) and HRFormer-B's branch 0 at 256x192
SHAPES = [(2, 18, 13, 16, 2), (2, 14, 14, 32, 4), (2, 7, 6, 24, 3), (1, 64, 48, 78, 2)]
T = torch.from_numpy


def _attn_params(rng, c):
    """LN1 scale/bias and flax-layout projections ([in, out]) with biases."""
    f = lambda: (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)  # noqa: E731
    b = lambda: (0.1 * rng.randn(c)).astype(np.float32)  # noqa: E731
    return [rng.uniform(0.5, 1.5, c).astype(np.float32), b(), f(), b(), f(), b(), f(), b(), f(),
            b()]


def _torch_attn(p):
    """The port's layouts: Linear weights [out, in]."""
    g, b, wq, bq, wk, bk, wv, bv, wo, bo = map(T, p)
    return g, b, wq.T, bq, wk.T, bk, wv.T, bv, wo.T, bo


def _mlp_params(rng, c, d):
    """Unfolded MlpDWBN weights in flax layouts and three BNs' (scale, bias,
    mean, var), then each side's fold: (jax [w1 [C,D], b1, dw [3,3,D], bdw,
    w2 [D,C], b2], torch [w1 [D,C], b1, dw [D,3,3], bdw, w2 [C,D], b2])."""
    conv = [(rng.randn(c, d) / np.sqrt(c)), 0.1 * rng.randn(d), rng.randn(3, 3, d) / 3,
            0.1 * rng.randn(d), rng.randn(d, c) / np.sqrt(d), 0.1 * rng.randn(c)]
    bns = [(rng.uniform(0.5, 1.5, n), 0.1 * rng.randn(n), 0.1 * rng.randn(n),
            rng.uniform(0.5, 1.5, n)) for n in (d, d, c)]
    conv = [a.astype(np.float32) for a in conv]
    bns = [tuple(a.astype(np.float32) for a in bn) for bn in bns]
    jx, pt = [], []
    for (w, bias), bn in zip(zip(conv[::2], conv[1::2]), bns):
        k, sh = (np.asarray(a) for a in jax_fold_bn(*bn))
        jx += [w * k, bias * k + sh]
        kt, sht = fold_bn(*map(T, bn))
        wt = T(w)
        wt = wt.permute(2, 0, 1) if wt.dim() == 3 else wt.T  # [out, ...] torch layouts
        pt += [wt * kt.reshape(-1, *[1] * (wt.dim() - 1)), T(bias) * kt + sht]
    return jx, pt


def _x(rng, shape):
    return (rng.rand(*shape) * 2 - 1).astype(np.float32)


@pytest.mark.parametrize("p,h,w,c,heads", SHAPES)
def test_plain_window_attn_block_matches_pallas(rng, p, h, w, c, heads):
    x, prm = _x(rng, (p, h, w, c)), _attn_params(rng, c)
    ref = np.asarray(jax_window_attn(x, *prm, heads=heads, interpret=True))
    got = window_attn_block_torch(T(x), *_torch_attn(prm), heads).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p,h,w,c,heads", SHAPES)
def test_plain_mlp_block_matches_pallas(rng, p, h, w, c, heads):
    x = _x(rng, (p, h, w, c))
    ln = [rng.uniform(0.5, 1.5, c).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)]
    jx, pt = _mlp_params(rng, c, 4 * c)
    ref = np.asarray(jax_mlp_block(x, *ln, *jx, interpret=True))
    got = mlp_block_torch(T(x), *map(T, ln), *pt).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("p,h,w,c,heads", SHAPES)
def test_plain_mlp_dwbn_matches_pallas(rng, p, h, w, c, heads):
    x = _x(rng, (p, h, w, c))
    jx, pt = _mlp_params(rng, c, 4 * c)
    ref = np.asarray(jax_mlp_dwbn(x, *jx, interpret=True))
    got = mlp_dwbn_torch(T(x), *pt).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def _ln(rng, c):
    return [rng.uniform(0.5, 1.5, c).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)]


@pytest.mark.parametrize("p,h,w,c,heads", SHAPES)
def test_plain_full_block_matches_pallas(rng, p, h, w, c, heads):
    """Kernel 7's plain version (E's then F's) vs the one-pass Pallas kernel."""
    x, prm, ln2 = _x(rng, (p, h, w, c)), _attn_params(rng, c), _ln(rng, c)
    jx, pt = _mlp_params(rng, c, 4 * c)
    ref = np.asarray(jax_full_block(x, *prm, *ln2, *jx, heads=heads, interpret=True))
    got = full_block_torch(T(x), *_torch_attn(prm), *map(T, ln2), *pt, heads).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel", ["E", "F", "G", "7"])
def test_plain_versions_match_pallas_in_bfloat16(rng, kernel):
    p, h, w, c, heads = 2, 18, 13, 16, 2
    x = _x(rng, (p, h, w, c))
    xj, xt = jnp.asarray(x, jnp.bfloat16), T(x).to(torch.bfloat16)
    if kernel == "E":
        prm = _attn_params(rng, c)
        ref = jax_window_attn(xj, *prm, heads=heads, interpret=True)
        got = window_attn_block_torch(xt, *_torch_attn(prm), heads)
    elif kernel == "7":
        prm, ln2 = _attn_params(rng, c), _ln(rng, c)
        jx, pt = _mlp_params(rng, c, 4 * c)
        ref = jax_full_block(xj, *prm, *ln2, *jx, heads=heads, interpret=True)
        got = full_block_torch(xt, *_torch_attn(prm), *map(T, ln2), *pt, heads)
    else:
        jx, pt = _mlp_params(rng, c, 4 * c)
        if kernel == "F":
            ln = [rng.uniform(0.5, 1.5, c).astype(np.float32),
                  (0.1 * rng.randn(c)).astype(np.float32)]
            ref = jax_mlp_block(xj, *ln, *jx, interpret=True)
            got = mlp_block_torch(xt, *map(T, ln), *pt)
        else:
            ref = jax_mlp_dwbn(xj, *jx, interpret=True)
            got = mlp_dwbn_torch(xt, *pt)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    got = got.float().numpy()
    err = np.abs(got - ref)
    assert err.max() <= BF16_REL * np.abs(ref).max(), err.max()
    assert (err == 0).mean() > 0.9  # the same rounding points: most elements agree exactly


def test_wrappers_take_plain_path_on_cpu(rng):
    """On CPU tensors Kernels E, F, G and 7's wrappers are their plain
    versions; no launch is counted."""
    reset_launches()
    x = T(_x(rng, (2, 9, 8, 16)))
    attn = _torch_attn(_attn_params(rng, 16))
    _, pt = _mlp_params(rng, 16, 32)
    ln = (T(rng.uniform(0.5, 1.5, 16).astype(np.float32)), T(np.zeros(16, np.float32)))
    assert torch.equal(window_attn_block_fused(x, *attn, heads=2),
                       window_attn_block_torch(x, *attn, 2))
    assert torch.equal(mlp_block_fused(x, *ln, *pt), mlp_block_torch(x, *ln, *pt))
    assert torch.equal(mlp_dwbn_fused(x, *pt), mlp_dwbn_torch(x, *pt))
    assert torch.equal(full_block_fused(x, *attn, *ln, *pt, heads=2),
                       full_block_torch(x, *attn, *ln, *pt, 2))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)


def test_wrappers_refuse_other_devices():
    x = torch.empty(1, 7, 7, 16, device="meta")
    w = torch.empty(16, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        window_attn_block_fused(x, None, None, w, None, w, None, w, None, w, None, heads=2)
    w1, dw, w2 = (torch.empty(*s, device="meta") for s in ((32, 16), (32, 3, 3), (16, 32)))
    with pytest.raises(ValueError, match="unsupported device"):
        mlp_block_fused(x, None, None, w1, None, dw, None, w2, None)
    with pytest.raises(ValueError, match="unsupported device"):
        mlp_dwbn_fused(x, w1, None, dw, None, w2, None)
    with pytest.raises(ValueError, match="unsupported device"):
        full_block_fused(x, None, None, w, None, w, None, w, None, w, None, None, None,
                         w1, None, dw, None, w2, None, heads=2)


def test_signatures_cover_the_new_entry_points():
    sig = build.SIGNATURES
    assert {"i2r_window_attn_fwd", "i2r_mlp_block_fwd", "i2r_mlp_dwbn_fwd",
            "i2r_full_block_fwd", "i2r_full_block_plan"} <= set(sig)
    # F and kernel 7 take F's plan (th, tw, slices) and the slices' f32 scratch; E, kernel
    # 9's forward and kernel 7 E's plan (group, cols), its fragments and the scratch o
    assert len(sig["i2r_mlp_block_fwd"]) == 22 and len(sig["i2r_full_block_fwd"]) == 35
    assert len(sig["i2r_full_block_plan"]) == 13 and len(sig["i2r_mlp_dwbn_fwd"]) == 19
    assert len(sig["i2r_window_attn_fwd"]) == 21 and len(sig["i2r_window_attn_train_fwd"]) == 23
