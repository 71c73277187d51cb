"""Kernel D: the post-norm DETR encoder FFN tail with dropout (training).

Replaces ``i2rnet_tpu/ops/pallas/encoder_ffn_train.py::encoder_ffn_train``
(dispatch ``encoder_ffn_train_auto``); the kernels are
``csrc/encoder_ffn_train.cu`` (forward; backward for dx and all eight
parameter gradients). :func:`encoder_ffn_train_torch` is the plain PyTorch
version under autograd, rounding where ``encoder_ffn_train.py:84-119`` does:

    n   = LN1(x)                            f32 statistics, eps 1e-5
    h   = T(n) . T(W1)^T + b1               f32 accumulation
    a   = T(drop1(relu(h)))
    y   = drop2(a . T(W2)^T + b2)
    out = T(LN2(n + y))                     residual on the f32 n

with T the activation dtype and ``drop: keep ? v / (1 - rate) : 0``. Weights
are in the torch ``nn.Linear`` layout (``w1`` [F, C], ``w2`` [C, F]); the
LayerNorm parameters and biases are f32, and so are their gradients.
Dropout (``ops/cuda/dropout.py``): ``dropout_bits = (bits1 [R, F], bits2 [R,
C])`` over the R rows, or ``dropout_seed`` with ``dropout_offset`` for the
first site and ``dropout_offset + 1`` for the second (Philox counted by
(column, row)).

In bfloat16 the forward is one launch of the tensor-core tile body
(``csrc/ffn_tile.cuh``, shared with Kernel B) and the backward three, both
following :func:`~.encoder_ffn.ffn_plan`; the float32 instances keep the
CUDA-core template.
"""

from __future__ import annotations

from typing import Optional

import torch

from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.dropout import (as_words, check_mode, kernel_args, keep_mask,
                                               philox_bits)
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import (_DTYPE_CODES, _F32_WARPS, _layer_norm,
                                                   check_f32_fits, ffn_plan)
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import sm_count

_ROWS_PER_BLOCK = 8  # the f32 template: one row per warp per step
_OUTER_SPLITS = 16  # the f32 template's row slices of a weight gradient (kOuterSplits)


def f32_smem(c: int, f: int, backward: bool = False) -> int:
    """Shared memory of Kernel D's f32 template (``encoder_ffn_train.cu::
    fwd_smem``/``bwd_smem``): W1, W2 at odd row strides, the vectors, and the
    warps' scratch."""
    params = f * (c + 1) + c * (f + 1) + f + 5 * c
    scratch = 5 * c + 2 * f + 5 * c + f if backward else 3 * c + f
    return 4 * (params + _F32_WARPS * scratch)


def ffn_bits(seed: int, offset: int, rows: int, width: int, device=None):
    """The seed-mode bits ``[rows, width]`` (int64) of the site keyed by ``offset``."""
    return philox_bits(seed, offset, torch.arange(width, device=device)[None, :],
                       torch.arange(rows, device=device)[:, None], 0)


def encoder_ffn_train_torch(x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias,
                            dropout_rate: float = 0.0, dropout_bits=None,
                            dropout_seed: Optional[int] = None, dropout_offset: int = 0,
                            eps: float = 1e-5):
    """Plain PyTorch training FFN tail over the rows of ``x`` ``[..., C]``."""
    dt = x.dtype
    c, f = x.shape[-1], w1.shape[0]
    mode = check_mode(dropout_rate, dropout_bits, dropout_seed)

    def t_f32(a):  # the value once stored in T, as f32
        return a.to(dt).float()

    x2 = x.reshape(-1, c)
    rows = x2.shape[0]
    if mode == "bits":
        bits1, bits2 = dropout_bits
    elif mode == "seed":
        bits1 = ffn_bits(dropout_seed, dropout_offset, rows, f, x.device)
        bits2 = ffn_bits(dropout_seed, dropout_offset + 1, rows, c, x.device)
    inv = 1.0 / (1.0 - dropout_rate)

    n = _layer_norm(x2, n1_weight, n1_bias, eps)
    a = torch.relu(torch.matmul(t_f32(n), t_f32(w1).t()) + b1)
    if mode != "none":
        a = torch.where(keep_mask(bits1, dropout_rate), a * inv, 0.0)
    y = torch.matmul(t_f32(a), t_f32(w2).t()) + b2
    if mode != "none":
        y = torch.where(keep_mask(bits2, dropout_rate), y * inv, 0.0)
    return _layer_norm(n + y, n2_weight, n2_bias, eps).to(dt).reshape(x.shape)


def _dropout_args(mode, rate, words, seed, offset):
    ptrs = (None, None) if words is None else tuple(w.data_ptr() for w in words)
    return (*ptrs, *kernel_args(mode, rate, seed, offset))


def _sms(x2) -> int:
    return sm_count(x2.device.index or 0)


def _grid(x2):
    """The f32 template's blocks: one row a warp, at most one block per SM."""
    return min(-(-x2.shape[0] // _ROWS_PER_BLOCK), _sms(x2))


def ffn_train_fwd(x2, params, eps: float, mode: str, rate: float, words, seed, offset):
    """Launch the forward kernel on ``[R, C]`` rows; ``params`` are the eight
    f32 tensors (LN1 w/b, W1, b1, W2, b2, LN2 w/b; the bf16 body rounds the
    weights as it loads them)."""
    rows, c = x2.shape
    f = params[2].shape[0]
    out = torch.empty_like(x2)
    grid = ffn_plan(rows, c, f, _sms(x2)).grid if x2.dtype == torch.bfloat16 else _grid(x2)
    err = build.library().i2r_ffn_train_fwd(
        x2.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(), rows, c, f, float(eps),
        _DTYPE_CODES[x2.dtype], grid, *_dropout_args(mode, rate, words, seed, offset),
        torch.cuda.current_stream(x2.device).cuda_stream)
    build.check(err, "encoder_ffn_train forward kernel")
    tracing.count("kernel.encoder_ffn_train_fwd")
    return out


def ffn_train_bwd(x2, gout, params, eps: float, mode: str, rate: float, words, seed, offset):
    """Launch the backward kernels (bf16: three, as :func:`~.encoder_ffn.ffn_plan`
    says; f32: the CUDA-core template's six); returns ``(dx, dln1_w, dln1_b,
    dw1, db1, dw2, db2, dln2_w, dln2_b)``, dx in x's dtype and the rest f32."""
    rows, c = x2.shape
    f = params[2].shape[0]
    dev, dt = x2.device, x2.dtype
    if dt == torch.bfloat16:
        plan = ffn_plan(rows, c, f, _sms(x2), backward=True)
        grid, slice_rows, cw, fw = plan.bwd_grid, plan.slice_rows, plan.cp, plan.fp
        w_part = torch.empty(plan.part_numel, device=dev)
    else:
        grid, slice_rows, cw, fw = _grid(x2), 0, c, f
        w_part = torch.empty(_OUTER_SPLITS, f, c, device=dev)
    dx = torch.empty_like(x2)
    # the rounded operands of the weight gradients: T(n), T(dy) [R, cw]; T(a), T(da) [R, fw]
    nb, dyb = (torch.empty(rows, cw, device=dev, dtype=dt) for _ in range(2))
    ab, dab = (torch.empty(rows, fw, device=dev, dtype=dt) for _ in range(2))
    nvec = 5 * c + f
    vec_part = torch.empty(grid, nvec, device=dev)
    d_vec = torch.empty(nvec, device=dev)
    dw1, dw2 = torch.empty(f, c, device=dev), torch.empty(c, f, device=dev)
    err = build.library().i2r_ffn_train_bwd(
        x2.data_ptr(), gout.data_ptr(), *(p.data_ptr() for p in params), dx.data_ptr(),
        nb.data_ptr(), ab.data_ptr(), dyb.data_ptr(), dab.data_ptr(), vec_part.data_ptr(),
        w_part.data_ptr(), d_vec.data_ptr(), dw1.data_ptr(), dw2.data_ptr(), rows, c, f,
        float(eps), _DTYPE_CODES[dt], grid, slice_rows,
        *_dropout_args(mode, rate, words, seed, offset),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "encoder_ffn_train backward kernels")
    tracing.count("kernel.encoder_ffn_train_bwd")
    dln1_w, dln1_b, db1, db2, dln2_w, dln2_b = torch.split(d_vec, [c, c, f, c, c, c])
    return dx, dln1_w, dln1_b, dw1, db1, dw2, db2, dln2_w, dln2_b


class _FfnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias,
                eps, mode, rate, words1, words2, seed, offset):
        c = x.shape[-1]
        x2 = x.reshape(-1, c).contiguous()
        # f32 as the kernels take them (no copy where they already are)
        params = [p.detach().to(x.device, torch.float32).contiguous() for p in
                  (n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias)]
        words = None if words1 is None else (words1, words2)
        out = ffn_train_fwd(x2, params, eps, mode, rate, words, seed, offset)
        ctx.save_for_backward(x2, *params, words1, words2)
        ctx.config = (x.shape, eps, mode, rate, seed, offset,
                      [p.dtype for p in (n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias)])
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, gout):
        x2, *rest = ctx.saved_tensors
        params, (words1, words2) = rest[:8], rest[8:]
        shape, eps, mode, rate, seed, offset, dtypes = ctx.config
        words = None if words1 is None else (words1, words2)
        g = gout.reshape(x2.shape).to(x2.dtype).contiguous()
        dx, *dparams = ffn_train_bwd(x2, g, params, eps, mode, rate, words, seed, offset)
        dparams = [d.to(t) for d, t in zip(dparams, dtypes)]
        return (dx.reshape(shape), *dparams, None, None, None, None, None, None, None)


def encoder_ffn_train_fused(x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias,
                            dropout_rate: float = 0.0, dropout_bits=None,
                            dropout_seed: Optional[int] = None, dropout_offset: int = 0,
                            eps: float = 1e-5):
    """The training FFN tail through the CUDA kernels, differentiable in x and
    the eight parameters.

    CPU tensors take :func:`encoder_ffn_train_torch`; CUDA tensors launch the
    kernels or raise: float32 any C and F whose f32 weights fit shared memory
    (:func:`f32_smem`; not C = F = 192, whose weights alone are 295 KB),
    bfloat16 what :func:`~.encoder_ffn.ffn_plan` takes.
    """
    if x.device.type == "cpu":
        return encoder_ffn_train_torch(x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight,
                                       n2_bias, dropout_rate, dropout_bits, dropout_seed,
                                       dropout_offset, eps)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_ffn_train_fused: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    f = w1.shape[0]
    if w1.shape != (f, c) or w2.shape != (c, f) or b1.shape != (f,):
        raise ValueError(f"linear1 [F, C] / linear2 [C, F] mismatch for C={c}: "
                         f"{tuple(w1.shape)} {tuple(w2.shape)} {tuple(b1.shape)}")
    if any(p.shape != (c,) for p in (n1_weight, n1_bias, b2, n2_weight, n2_bias)):
        raise ValueError(f"LayerNorm parameters and b2 must be [C={c}]")
    rows = x.numel() // c
    if rows == 0:
        raise ValueError("encoder_ffn_train_fused: no rows")
    if x.dtype == torch.float32:
        check_f32_fits(c, f, f32_smem(c, f, backward=True), "encoder_ffn_train")
    mode = check_mode(dropout_rate, dropout_bits, dropout_seed)
    words1 = words2 = None
    if mode == "bits":
        bits1, bits2 = dropout_bits
        if tuple(bits1.shape) != (rows, f) or tuple(bits2.shape) != (rows, c):
            raise ValueError(f"dropout_bits must be ([R, F], [R, C]) = ({(rows, f)}, {(rows, c)}), "
                             f"got {tuple(bits1.shape)} {tuple(bits2.shape)}")
        words1, words2 = as_words(bits1.to(x.device)), as_words(bits2.to(x.device))
    return _FfnTrain.apply(x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias,
                           float(eps), mode, float(dropout_rate), words1, words2,
                           None if dropout_seed is None else int(dropout_seed),
                           int(dropout_offset))
