"""Kernel B: the post-norm DETR encoder FFN tail (eval forward).

Replaces ``i2rnet_tpu/ops/pallas/encoder_ffn.py::encoder_ffn_fused``; the
kernel is ``csrc/encoder_ffn.cu``. :func:`encoder_ffn_torch` is its plain
PyTorch version and mirrors ``_ffn_jnp`` (encoder_ffn.py:60-74) cast for cast:

    n   = LN1(x)                      f32 statistics, eps 1e-5
    h   = relu(T(n) . T(W1)^T + b1)   f32 accumulation, then cast to T
    y   = T(h) . T(W2)^T + b2         f32 accumulation
    out = T(LN2(n + y))               residual on the f32 n

with T the activation dtype. Weights are in the torch ``nn.Linear`` layout
(``w1`` [F, C], ``w2`` [C, F]); LayerNorm parameters and biases are f32.
"""

from __future__ import annotations

import torch

from i2rnet_tpu_torch.ops.cuda import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 8  # one row per warp per step


def _layer_norm(v, g, b, eps):
    vf = v.float()
    mean = vf.mean(-1, keepdim=True)
    var = ((vf - mean) ** 2).mean(-1, keepdim=True)
    return (vf - mean) * torch.rsqrt(var + eps) * g + b


def encoder_ffn_torch(x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias,
                      eps: float = 1e-5):
    """Plain PyTorch ``LN2(n + linear2(relu(linear1(n))))``, ``n = LN1(x)``.

    The products take T-rounded operands and accumulate in f32 (the operands
    are cast to T, then multiplied as f32), as ``preferred_element_type``
    does in the JAX version.
    """
    dt = x.dtype

    def t_f32(a):  # the value once stored in T, as f32
        return a.to(dt).float()

    n = _layer_norm(x, n1_weight, n1_bias, eps)
    h = torch.relu(torch.matmul(t_f32(n), t_f32(w1).t()) + b1)
    y = torch.matmul(t_f32(h), t_f32(w2).t()) + b2
    return _layer_norm(n + y, n2_weight, n2_bias, eps).to(dt)


def encoder_ffn_fused(x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias,
                      eps: float = 1e-5):
    """The FFN tail through the CUDA kernel over the rows of ``x`` ``[..., C]``.

    CPU tensors take :func:`encoder_ffn_torch`; CUDA tensors launch the kernel
    or raise.
    """
    if x.device.type == "cpu":
        return encoder_ffn_torch(x, n1_weight, n1_bias, w1, b1, w2, b2,
                                 n2_weight, n2_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"encoder_ffn_fused: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    f = w1.shape[0]
    if w1.shape != (f, c) or w2.shape != (c, f) or b1.shape != (f,):
        raise ValueError(f"linear1 [F, C] / linear2 [C, F] mismatch for C={c}: "
                         f"{tuple(w1.shape)} {tuple(w2.shape)} {tuple(b1.shape)}")
    if any(p.shape != (c,) for p in (n1_weight, n1_bias, b2, n2_weight, n2_bias)):
        raise ValueError(f"LayerNorm parameters and b2 must be [C={c}]")
    g1, be1, b1f, b2f, g2, be2 = (p.detach().to(x.device, torch.float32).contiguous()
                                  for p in (n1_weight, n1_bias, b1, b2, n2_weight, n2_bias))
    w1t = w1.detach().to(x.device, x.dtype).contiguous()
    w2t = w2.detach().to(x.device, x.dtype).contiguous()
    x2 = x.reshape(-1, c).contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:
        return out.reshape(x.shape)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = min(-(-rows // _ROWS_PER_BLOCK), 2 * sms)
    err = build.library().i2r_encoder_ffn_fwd(
        x2.data_ptr(), g1.data_ptr(), be1.data_ptr(), w1t.data_ptr(), b1f.data_ptr(),
        w2t.data_ptr(), b2f.data_ptr(), g2.data_ptr(), be2.data_ptr(), out.data_ptr(),
        rows, c, f, float(eps), _DTYPE_CODES[x.dtype], grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "encoder_ffn kernel")
    encoder_ffn_fused.launches += 1
    return out.reshape(x.shape)


encoder_ffn_fused.launches = 0
