"""Kernel G: the HRFormer MlpDWBN chain alone, BatchNorms folded (eval).

Replaces ``i2rnet_tpu/ops/pallas/mlp_dwbn.py::mlp_dwbn_fused``; the kernel is
``csrc/mlp_dwbn.cu`` (one templated source with Kernel F). :func:`mlp_dwbn_torch`
is its plain PyTorch version and follows the Pallas kernel's numerics
(``mlp_dwbn.py:73-95``): x, weights and the hidden map all in f32,

    h   = gelu(x . W1^T + b1)                 1x1 expand, C -> D
    h   = gelu(dw3x3(h) + bdw)                depthwise 3x3, zero border
    out = T(gelu(h . W2^T + b2))              1x1 contract, D -> C

with the Abramowitz-Stegun erf GELU (:func:`gelu_exact`) and one cast to the
input dtype T at the end. Also here, shared with Kernel F: :func:`fold_bn`,
the tanh-form GELU :func:`gelu_tanh_erf` (constants copied from the JAX
module) and the packing and launch of the shared source.

Layouts: ``x`` ``[P, H, W, C]``; ``w1`` ``[D, C]`` and ``w2`` ``[C, D]`` (a
1x1 convolution's weight without its 1x1), ``dw`` ``[D, 3, 3]`` (a depthwise
convolution's weight without its group axis); biases f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from i2rnet_tpu_torch.ops.cuda import build

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: tanh-form erf fit of the JAX package (``mlp_dwbn.py:62``):
#: erf(x / sqrt 2) = tanh(x (c0 + x^2 (c1 + ...))), |error| <= 5.9e-6 in f32
GELU_TANH_C = (7.978695036392e-01, 3.639282100698e-02, -8.813181379539e-05,
               -3.663829767474e-05, 1.422091515310e-06)
#: Abramowitz & Stegun 7.1.26 (``mlp_dwbn.py:40-50``), max |error| ~1.5e-7
_AS_P = 0.3275911
_AS_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
BN_EPS = 1e-5


def fold_bn(weight, bias, mean, var, eps: float = BN_EPS):
    """(k, c) with ``BN(x) == x * k + c`` (eval statistics), in f32."""
    k = weight.float() * torch.rsqrt(var.float() + eps)
    return k, bias.float() - mean.float() * k


def _erf(x):
    ax = x.abs()
    t = 1.0 / (1.0 + _AS_P * ax)
    a1, a2, a3, a4, a5 = _AS_A
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp(-ax * ax))


def gelu_exact(x):
    """GELU with the Abramowitz-Stegun erf of the Pallas kernel (f32)."""
    return 0.5 * x * (1.0 + _erf(x * 0.7071067811865476))


def gelu_tanh_erf(x):
    """GELU with the tanh-form erf fit (f32), as ``_gelu_tanh_erf``."""
    c0, c1, c2, c3, c4 = GELU_TANH_C
    z = x * x
    p = x * (c0 + z * (c1 + z * (c2 + z * (c3 + z * c4))))
    return 0.5 * x * (1.0 + torch.tanh(p))


def depthwise3x3(h, dw):
    """Nine shifted f32 multiply-adds over ``h`` ``[P, H, W, D]`` with a zero
    border, tap order (dy, dx) row-major from a zero sum, as the Pallas
    kernels; ``dw`` ``[D, 3, 3]`` f32."""
    _, hh, ww, _ = h.shape
    padded = F.pad(h, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros_like(h)
    for dy in range(3):
        for dx in range(3):
            acc = acc + padded[:, dy:dy + hh, dx:dx + ww, :] * dw[:, dy, dx]
    return acc


def mlp_dwbn_torch(x, w1, b1, dw, bdw, w2, b2):
    """Plain PyTorch MlpDWBN with folded BatchNorms, all f32 (see the module
    docstring); returns x's dtype."""
    w1, b1, dw, bdw, w2, b2 = (t.float() for t in (w1, b1, dw, bdw, w2, b2))
    h = gelu_exact(torch.matmul(x.float(), w1.t()) + b1)
    h = gelu_exact(depthwise3x3(h, dw) + bdw)
    return gelu_exact(torch.matmul(h, w2.t()) + b2).to(x.dtype)


def pack_mlp(w1, b1, dw, bdw, w2, b2, wdtype, device):
    """The kernel's weight layout: ``W1^T`` [C, D] and ``W2^T`` [D, C] in
    ``wdtype``, the taps [3, 3, D] and the biases in f32, on ``device``."""
    w1t = w1.detach().to(device, wdtype).t().contiguous()
    w2t = w2.detach().to(device, wdtype).t().contiguous()
    dwt = dw.detach().to(device, torch.float32).permute(1, 2, 0).contiguous()
    b1f, bdwf, b2f = (t.detach().to(device, torch.float32).contiguous() for t in (b1, bdw, b2))
    return w1t, b1f, dwt, bdwf, w2t, b2f


def check_cuda_mlp(x, w1, dw, w2, what):
    """Device, dtype and shapes of an MlpDWBN kernel call; raises on what the
    kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 4 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: x must be float32 or bfloat16 [P, H, W, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    c, d = x.shape[-1], w1.shape[0]
    if w1.shape != (d, c) or w2.shape != (c, d) or dw.shape != (d, 3, 3):
        raise ValueError(f"{what}: w1 [D, C], dw [D, 3, 3], w2 [C, D] mismatch for C={c}: "
                         f"{tuple(w1.shape)} {tuple(dw.shape)} {tuple(w2.shape)}")


def launch_mlp(lib_fn, x, ln, packed, what):
    """One launch of ``csrc/mlp_dwbn.cu``: Kernel F when ``ln`` is (scale,
    bias, eps), Kernel G when it is None. Returns ``[P, H, W, C]``."""
    p, h, w, c = x.shape
    w1t, b1f, dwt, bdwf, w2t, b2f = packed
    xc = x.contiguous()
    out = torch.empty_like(xc)
    args = [xc.data_ptr()]
    if ln is not None:
        g, b = (t.detach().to(x.device, torch.float32).contiguous() for t in ln[:2])
        args += [g.data_ptr(), b.data_ptr()]
    args += [w1t.data_ptr(), b1f.data_ptr(), dwt.data_ptr(), bdwf.data_ptr(), w2t.data_ptr(),
             b2f.data_ptr(), out.data_ptr(), p, h, w, c, w1t.shape[1]]
    if ln is not None:
        args.append(float(ln[2]))
    err = lib_fn(*args, DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, what)
    return out


def mlp_dwbn_fused(x, w1, b1, dw, bdw, w2, b2, packed=None):
    """MlpDWBN (folded BNs) through Kernel G over ``x`` ``[P, H, W, C]``.

    CPU tensors take :func:`mlp_dwbn_torch`; CUDA tensors launch the kernel
    or raise. ``packed``, when given, is :func:`pack_mlp` of the same weights
    in f32 on x's device (a caller's cache).
    """
    if x.device.type == "cpu":
        return mlp_dwbn_torch(x, w1, b1, dw, bdw, w2, b2)
    check_cuda_mlp(x, w1, dw, w2, "mlp_dwbn_fused")
    if x.numel() == 0:
        return torch.empty_like(x)
    if packed is None:
        packed = pack_mlp(w1, b1, dw, bdw, w2, b2, torch.float32, x.device)
    out = launch_mlp(build.library().i2r_mlp_dwbn_fwd, x, None, packed, "mlp_dwbn kernel")
    mlp_dwbn_fused.launches += 1
    return out


mlp_dwbn_fused.launches = 0
