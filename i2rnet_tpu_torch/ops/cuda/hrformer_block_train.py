"""Kernel 9: the HRFormer window-attention half block for training.

Replaces ``i2rnet_tpu/ops/pallas/hrformer_block_train.py::window_attn_block_train``:

    out = x + s[:, None, None, None] * unpad(WindowMHSA(LN1(x)))

over ``x`` ``[P, H, W, C]``, with ``s`` ``[P]`` the per-sample droppath scale
(0 or 1/keep; ones when the rate is 0). Nothing flows to ``s``.

:func:`window_attn_block_train_torch` is the plain version, autograd its
backward. Its forward rounds where ``_fwd_kernel`` rounds (:104-156), with T
the activation dtype: Kernel E's arithmetic (``hrformer_block.py``) up to the
out-projection, then ``out = x + T(s * (o . T(Wo)^T + bo))`` with the product
in f32.

:func:`window_attn_block_train_fused` runs the CUDA kernels under a
``torch.autograd.Function``:

* forward: Kernel E's launches (its bf16 tensor-core body in two passes, or
  its f32 template) with the scale ``s`` and a second output, the window
  tokens ``t2 = T(LN1(x))`` ``[P, nwin, 49, C]`` (exactly 0 at the pad
  tokens), saved for the backward (``csrc/window_attn_block.cu``);
* backward (``csrc/window_attn_block_train.cu``): K1, the attention
  backward per (window, person), from ``t2`` and ``da2 = T(s * dy)`` on the
  windows; then K2, the LayerNorm backward per row of pixels, ``dx = dy +
  T(LN1'(dt2))``; then the weight gradients ``dW = sum_tokens`` of outer
  products by a tiled fixed-order reduction. K1 rounds where ``_attn_bwd_kernel``
  rounds (:163-240): ``doh``, ``dsb`` and ``dq3b``/``dk3b``/``dv3b`` in T before
  their products; the bias gradients sum the f32 values.

Gradients come back in the torch ``Linear`` layouts, f32, the 1/sqrt(d) fold
undone on ``dWq`` and ``dbq`` (``unpack_head_grads``, :295-318). The weight
layout is Kernel E's :func:`~.hrformer_block.pack_attn`.
"""

from __future__ import annotations

import math

import torch

from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (LN_EPS, WINDOW, attn_launch_plan,
                                                      check_cuda_attn, ln_f32, pack_attn,
                                                      window_attn_f32)
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import DTYPE_CODES

#: row slices of the weight-gradient reduction (``csrc/common.cuh``)
W_SPLITS = 16


def window_attn_block_train_torch(x, s, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                  heads: int, window: int = WINDOW, eps: float = LN_EPS):
    """Plain PyTorch ``x + s * WindowMHSA(LN1(x))`` with kernel 9's forward
    rounding; differentiable in x and the ten parameters."""
    a = window_attn_f32(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, window, eps)
    return x + (s.detach().float()[:, None, None, None] * a).to(x.dtype)


def _nwin(h: int, w: int):
    nh, nw = -(-h // WINDOW), -(-w // WINDOW)
    return nh * nw


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def window_attn_train_fwd(x, s, ln, packed, heads: int, eps: float):
    """Launch the forward on contiguous ``x`` (Kernel E's launches with the
    droppath scale, :func:`~.hrformer_block.attn_plan` in bfloat16); ``packed``
    is :func:`~.hrformer_block.pack_attn`'s six tensors. Returns ``(out, t2)``."""
    p, h, w, c = x.shape
    g, b = ln
    plan, o = attn_launch_plan(x, heads)
    out = torch.empty_like(x)
    t2 = torch.empty(p, _nwin(h, w), WINDOW * WINDOW, c, device=x.device, dtype=x.dtype)
    err = build.library().i2r_window_attn_train_fwd(
        x.data_ptr(), s.data_ptr(), g.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in packed),
        o.data_ptr(), out.data_ptr(), t2.data_ptr(), p, h, w, c, heads, *plan, float(eps),
        DTYPE_CODES[x.dtype], _stream(x))
    build.check(err, "window_attn_block_train forward kernel")
    window_attn_train_fwd.launches += 1
    return out, t2


def window_attn_train_bwd(x, dy, s, t2, ln, packed, heads: int, eps: float):
    """Launch K1, K2 and the weight-gradient reduction; ``packed`` holds
    :func:`~.hrformer_block.pack_attn`'s first four tensors. Returns ``(dx,
    dln_w, dln_b, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo)``, dx in x's dtype,
    the rest f32 in the torch layouts."""
    p, h, w, c = x.shape
    g, _ = ln
    wqkv, bqkv, wot, _ = packed
    dev, dt = x.device, x.dtype
    nwin = _nwin(h, w)
    rows = p * nwin * WINDOW * WINDOW
    dx = torch.empty_like(x)
    tokens = torch.empty(6, rows, c, device=dev, dtype=dt)  # da2, o3, dq, dk, dv, dt2
    bias_part = torch.empty(p * nwin, 4 * c, device=dev)
    ln_part = torch.empty(p * h, 2 * c, device=dev)
    w_part = torch.empty(W_SPLITS, c, c, device=dev)
    d_vec = torch.empty(6 * c, device=dev)  # dbq, dbk, dbv, dbo, dln_w, dln_b
    dw = torch.empty(4, c, c, device=dev)   # dwq, dwk, dwv, dwo
    err = build.library().i2r_window_attn_train_bwd(
        x.data_ptr(), dy.data_ptr(), s.data_ptr(), t2.data_ptr(), g.data_ptr(), wqkv.data_ptr(),
        bqkv.data_ptr(), wot.data_ptr(), dx.data_ptr(), tokens.data_ptr(), bias_part.data_ptr(),
        ln_part.data_ptr(), w_part.data_ptr(), d_vec.data_ptr(), dw.data_ptr(), p, h, w, c,
        heads, float(eps), 1.0 / math.sqrt(c // heads), DTYPE_CODES[dt], _stream(x))
    build.check(err, "window_attn_block_train backward kernels")
    window_attn_train_bwd.launches += 1
    dbq, dbk, dbv, dbo, dln_w, dln_b = torch.split(d_vec, c)
    return dx, dln_w, dln_b, dw[0], dbq, dw[1], dbk, dw[2], dbv, dw[3], dbo


window_attn_train_fwd.launches = 0
window_attn_train_bwd.launches = 0


class _WindowAttnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps):
        xc = x.contiguous()
        sf = s.detach().to(x.device, torch.float32).contiguous()
        ln = ln_f32(ln_w, ln_b, x.device)
        packed = pack_attn(wq, bq, wk, bk, wv, bv, wo, bo, heads, x.dtype, x.device)
        out, t2 = window_attn_train_fwd(xc, sf, ln, packed, heads, eps)
        ctx.save_for_backward(xc, sf, t2, *ln, *packed[:4])
        ctx.config = (heads, eps, [t.dtype for t in (ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo)])
        return out

    @staticmethod
    def backward(ctx, dy):
        x, s, t2, g, b, *packed = ctx.saved_tensors
        heads, eps, dtypes = ctx.config
        dx, *grads = window_attn_train_bwd(x, dy.to(x.dtype).contiguous(), s, t2, (g, b),
                                           packed, heads, eps)
        return (dx, None, *(d.to(t) for d, t in zip(grads, dtypes)), None, None)


def window_attn_block_train_fused(x, s, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                  heads: int, window: int = WINDOW, eps: float = LN_EPS):
    """``x + s * WindowMHSA(LN1(x))`` through kernel 9, differentiable in x and
    the ten parameters (not in ``s``).

    CPU tensors take :func:`window_attn_block_train_torch`; CUDA tensors
    launch the kernels or raise. ``s`` is ``[P]``; weights in the torch
    ``Linear`` layout, ``[C, C]``.
    """
    if x.device.type == "cpu":
        return window_attn_block_train_torch(x, s, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                             heads, window, eps)
    if tuple(s.shape) != (x.shape[0],) or x.numel() == 0:
        raise ValueError(f"window_attn_block_train_fused: s must be [P] = [{x.shape[0]}] of a "
                         f"non-empty map, got {tuple(s.shape)} for {tuple(x.shape)}")
    check_cuda_attn(x, (wq, wk, wv, wo), heads, window, "window_attn_block_train_fused")
    return _WindowAttnTrain.apply(x, s, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads,
                                  float(eps))
