"""Kernels E and F, the two halves of an HRFormer transformer block (eval),
and kernel 7, the whole block in one launch.

Replace ``i2rnet_tpu/ops/pallas/hrformer_block.py::window_attn_block_fused``
(Kernel E, ``csrc/window_attn_block.cu``), ``::mlp_block_fused`` (Kernel F,
``csrc/mlp_dwbn.cu``) and ``::full_block_fused`` (kernel 7,
``csrc/full_block.cu``: E's then F's work on the same items, split by a
grid-wide barrier). Their plain PyTorch versions round where the JAX
kernels' ``_attn_math`` and ``_mlp_math`` round (:109-185), with T the
activation dtype:

E: ``x + WindowMHSA(LN1(x))``
    y   = T(LN1(x))                     f32 statistics over C, eps 1e-6
    windows of 7x7 tokens after zero center padding (pad tokens are 0 after
    LN; their q/k/v are the projection biases, and they are attended to)
    q   = T(y . T(s Wq)^T + s bq)       s = 1/sqrt(d) folded into Wq, bq in f32
    k,v = T(y . T(W)^T + b)             f32 accumulation
    o   = T(T(softmax(q . k^T)) . v)    per head, f32 logits and softmax
    out = x + T(o . T(Wo)^T + bo)       residual in T, real tokens only

F: ``x + MlpDWBN(LN2(x))`` with the BatchNorms folded (:func:`fold_bn`)
    y   = T(LN2(x))
    h   = T(gelu(y . T(W1)^T + b1))     1x1 expand, f32 accumulation
    h   = T(gelu(dw3x3(h) + bdw))       f32 taps, zero border of the H x W map
    out = x + T(gelu(h . T(W2)^T + b2)) 1x1 contract, residual in T

kernel 7: ``F(E(x))``, E's output rounded to T between the halves, as
``_block_kernel`` (:218-234) hands ``_attn_math``'s result to ``_mlp_math``.

GELU is the tanh-form fit :func:`gelu_tanh_erf`. Weights come in the torch
layouts (Linear ``[out, in]``; ``w1`` [D, C], ``dw`` [D, 3, 3], ``w2`` [C, D]);
LayerNorm parameters and biases are f32.

In bfloat16, E (and kernel 9's forward, and kernel 7's attention phases) runs
its tensor-core body in two passes, laid out by :func:`attn_plan`: pass 1 per
(window, head group, person) writes o ``[P, H, W, C]`` (rounded), pass 2 per
(64 rows, column block) the out-projection and residual; where a block of
pass 1 holds all heads, it runs the out-projection itself. Its weights are
packed as mma fragments by :func:`pack_attn`. float32 keeps the CUDA-core
template (``group = cols = 0``).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import (DTYPE_CODES, MAX_SMEM, check_cuda_mlp,
                                                depthwise3x3, gelu_tanh_erf, launch_plan,
                                                pack_fragments, pack_mlp, pad16, sm_count)

LN_EPS = 1e-6
WINDOW = 7  # the kernel's window (HRFormer-B's everywhere)
# E's bf16 tensor-core body, as ``csrc/window_attn.cuh`` compiles it
# (tests/test_torch_attn_tiles.py reads the same constants there)
ROWS = 64  #: rows of a window tile: the 49 tokens, then zeros (kRows)
MAX_DP = 64  #: the head dim padded to 16, at most (kMaxDp)
MAX_COLS = 16  #: 8-column n-tiles of the out-projection a block of pass 2, at most (kMaxCols)


def layer_norm_f32(x, weight, bias, eps: float = LN_EPS):
    """LayerNorm over the last axis in f32 (two-pass variance), as ``_ln``."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    diff = xf - mean
    var = (diff * diff).mean(-1, keepdim=True)
    return diff * torch.rsqrt(var + eps) * weight.float() + bias.float()


def window_partition(x, window: int):
    """``[B, H, W, C]`` -> zero center-padded windows ``[B*nh*nw, w*w, C]`` and
    the pad info (reference PadBlock, ``hrformer.py:175-189``)."""
    b, h, w, c = x.shape
    pad_h, pad_w = (-h) % window, (-w) % window
    x = F.pad(x, (0, 0, pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    hp, wp = h + pad_h, w + pad_w
    nh, nw = hp // window, wp // window
    x = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, window * window, c), (b, h, w, hp, wp, pad_h, pad_w)


def window_unpartition(x, window: int, info):
    """Inverse of :func:`window_partition`: the windows back on the map, the
    padding cut off (``hrformer.py:192-198``)."""
    b, h, w, hp, wp, pad_h, pad_w = info
    nh, nw = hp // window, wp // window
    c = x.shape[-1]
    x = x.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
    return x[:, pad_h // 2:pad_h // 2 + h, pad_w // 2:pad_w // 2 + w, :]


def _t32(a, dt):
    """The value of ``a`` once stored in ``dt``, as f32."""
    return a.to(dt).float()


def window_attn_f32(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                    window: int = WINDOW, eps: float = LN_EPS):
    """``o . T(Wo)^T + bo`` of E's arithmetic in f32 on the map, before the
    rounding and residual (differentiable)."""
    dt = x.dtype
    c = x.shape[-1]
    d = c // heads
    s = 1.0 / math.sqrt(d)
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(dt)
    win, info = window_partition(y, window)
    tf = win.float()

    def proj(w, b):
        return (torch.matmul(tf, _t32(w, dt).t()) + b.float()).to(dt)

    q = proj(wq.float() * s, bq.float() * s)
    k, v = proj(wk, bk), proj(wv, bv)
    nb, t, _ = q.shape

    def split(a):
        return a.reshape(nb, t, heads, d).transpose(1, 2).float()

    prob = torch.softmax(torch.matmul(split(q), split(k).transpose(-1, -2)), dim=-1)
    o = torch.matmul(_t32(prob, dt), split(v)).to(dt).transpose(1, 2).reshape(nb, t, c)
    return window_unpartition(torch.matmul(o.float(), _t32(wo, dt).t()) + bo.float(), window, info)


def window_attn_block_torch(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                            window: int = WINDOW, eps: float = LN_EPS):
    """Plain PyTorch ``x + WindowMHSA(LN1(x))`` with Kernel E's rounding."""
    a = window_attn_f32(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, window, eps)
    return x + a.to(x.dtype)


def mlp_block_torch(x, ln_w, ln_b, w1, b1, dw, bdw, w2, b2, eps: float = LN_EPS):
    """Plain PyTorch ``x + MlpDWBN(LN2(x))`` (folded BNs) with Kernel F's rounding."""
    dt = x.dtype
    y = layer_norm_f32(x, ln_w, ln_b, eps).to(dt)
    h = gelu_tanh_erf(torch.matmul(y.float(), _t32(w1, dt).t()) + b1.float()).to(dt)
    h = gelu_tanh_erf(depthwise3x3(h.float(), dw.float()) + bdw.float()).to(dt)
    out = gelu_tanh_erf(torch.matmul(h.float(), _t32(w2, dt).t()) + b2.float()).to(dt)
    return x + out


def pack_attn(wq, bq, wk, bk, wv, bv, wo, bo, heads: int, dtype, device):
    """Kernel E's weight layout on ``device``: ``Wqkv`` [C, heads, 3, d] (in
    features first; q scaled by 1/sqrt(d) in f32 before the cast to
    ``dtype``), ``bqkv`` [heads, 3, d] f32, ``Wo^T`` [C, C] in ``dtype``, ``bo``
    f32 (the CUDA-core template's, and kernel 9's backward's); then, in
    bfloat16, the tensor-core body's fragments (:func:`attn_fragments`), in
    float32 two empty tensors."""
    c = wq.shape[0]
    d = c // heads
    s = 1.0 / math.sqrt(d)
    ws = [wq.detach().float() * s, wk.detach().float(), wv.detach().float()]
    bs = [bq.detach().float() * s, bk.detach().float(), bv.detach().float()]
    wqkv = torch.stack([w.to(device, dtype).t().reshape(c, heads, d) for w in ws], dim=2)
    bqkv = torch.stack([b.to(device).reshape(heads, d) for b in bs], dim=1)
    wot = wo.detach().to(device, dtype).t().contiguous()
    if dtype == torch.bfloat16:
        frags = attn_fragments(wqkv, wot)
    else:
        frags = (torch.empty(0, dtype=dtype, device=device),) * 2
    return (wqkv.contiguous(), bqkv.contiguous(), wot,
            bo.detach().to(device, torch.float32).contiguous(), *frags)


def attn_fragments(wqkv, wot):
    """The bf16 body's weights from :func:`pack_attn`'s ``Wqkv`` [C, heads, 3,
    d] and ``Wo^T`` [C, C]: per head the [3 dp, C] matrix of its q, k, v output
    columns (dp = d padded to 16, zero past d) as mma B-operand fragments
    (:func:`~.mlp_dwbn.pack_fragments`, C padded to 16), ``[heads, 3 dp / 8,
    pad16(C) / 16, 32, 4]``; Wo [C out, C in] likewise, ``[pad16(C) / 8,
    pad16(C) / 16, 32, 4]``."""
    c, heads, _, d = wqkv.shape
    dp, cp = pad16(d), pad16(c)
    per_head = torch.zeros(heads, 3, dp, c, dtype=wqkv.dtype, device=wqkv.device)
    per_head[:, :, :d] = wqkv.permute(1, 2, 3, 0)
    return (pack_fragments(per_head.reshape(heads, 3 * dp, c), 3 * dp, cp),
            pack_fragments(wot.t(), cp, cp))


@dataclass(frozen=True)
class AttnPlan:
    """Kernel E's bf16 launches over ``p`` maps ``[h, w, c]`` of ``heads``
    heads (kernel 9's forward and kernel 7's attention phases take the same):
    pass 1, a block per (window, head group of ``group`` heads, person), grid
    (windows x groups, P), window ``win`` = blockIdx.x % windows; pass 2, a
    block per (64 rows of the P h w tokens, ``cols`` 8-column n-tiles of the
    pad16(c) / 8), grid (row blocks, column blocks). Where a group is all
    heads (``fused``) pass 1 runs the out-projection of its window itself and
    there is no pass 2 (grid (0, 0)). ``smem1``, ``smem2``: bytes of shared
    memory a block of each pass."""

    p: int
    h: int
    w: int
    c: int
    heads: int
    group: int
    cols: int

    @property
    def d(self) -> int:
        return self.c // self.heads

    @property
    def windows(self) -> int:
        return -(-self.h // WINDOW) * -(-self.w // WINDOW)

    @property
    def groups(self) -> int:
        return self.heads // self.group

    @property
    def fused(self) -> bool:
        return self.group == self.heads

    @property
    def grid1(self) -> tuple:
        return self.windows * self.groups, self.p

    @property
    def ntiles(self) -> int:
        return pad16(self.c) // 8

    @property
    def grid2(self) -> tuple:
        if self.fused:
            return 0, 0
        return -(-self.p * self.h * self.w // ROWS), -(-self.ntiles // self.cols)

    @property
    def blocks1(self) -> int:
        return self.grid1[0] * self.grid1[1]

    @property
    def blocks2(self) -> int:
        return self.grid2[0] * self.grid2[1]

    @property
    def smem1(self) -> int:
        """``window_attn.cuh::attn_mma_smem_bytes``: the window tile, q, k, v
        (bf16), the tokens' map coordinates; fused, the window's o too."""
        tiles = 2 if self.fused else 1
        return 2 * ROWS * (tiles * (pad16(self.c) + 8) + 3 * (pad16(self.d) + 8)) + 4 * 2 * ROWS

    @property
    def smem2(self) -> int:
        """``window_attn.cuh::attn_out_smem_bytes``: a block of o (bf16)."""
        return 2 * ROWS * (pad16(self.c) + 8)

    def group_heads(self, hg: int) -> range:
        return range(hg * self.group, (hg + 1) * self.group)

    def col_tiles(self, cb: int) -> range:
        """The n-tiles (8 output columns each) of column block ``cb``."""
        return range(cb * self.cols, min((cb + 1) * self.cols, self.ntiles))


@functools.lru_cache(maxsize=None)
def attn_plan(p: int, h: int, w: int, c: int, heads: int, sms: int = 132) -> AttnPlan:
    """Kernel E's bf16 launch plan on a card with ``sms`` SMs: all of a
    window's heads in one block of pass 1 where that grid holds two blocks
    per SM (then pass 1 runs the out-projection too), else the largest head
    group (a divisor of ``heads``) that does, down to one head a block; pass
    2's column blocks of at most ``MAX_COLS``
    n-tiles, split evenly until its grid holds two blocks per SM or each
    block has one n-tile. Raises ValueError where the head dim padded to 16
    exceeds ``MAX_DP`` or a block's shared memory ``MAX_SMEM``. The float32
    instances keep the CUDA-core template (one block per window and person).
    """
    d = c // heads
    if pad16(d) > MAX_DP:
        raise ValueError(f"the bf16 window-attention kernel takes head dims up to {MAX_DP}, "
                         f"got {d}")
    windows = -(-h // WINDOW) * -(-w // WINDOW)
    divisors = [g for g in range(heads, 0, -1) if heads % g == 0]
    group = next((g for g in divisors if windows * (heads // g) * p >= 2 * sms), 1)
    ntiles, row_blocks = pad16(c) // 8, -(-p * h * w // ROWS)
    splits = max(-(-ntiles // MAX_COLS), min(ntiles, -(-2 * sms // row_blocks)))
    plan = AttnPlan(p, h, w, c, heads, group, -(-ntiles // splits))
    if max(plan.smem1, plan.smem2) > MAX_SMEM:
        raise ValueError(f"the bf16 window-attention kernel does not fit C={c} in {MAX_SMEM} B")
    return plan


def attn_launch_plan(x, heads: int):
    """``(group, cols)`` of E's launch over ``x`` ``[P, H, W, C]`` (kernel 9's
    forward and kernel 7's attention phases too) and the scratch o:
    :func:`attn_plan` on x's device in bfloat16, o empty where pass 1 runs the
    out-projection itself (``AttnPlan.fused``); ``(0, 0)`` and o empty in
    float32, where the CUDA-core template needs no plan."""
    empty = torch.empty(0, dtype=x.dtype, device=x.device)
    if x.dtype != torch.bfloat16:
        return (0, 0), empty
    plan = attn_plan(*x.shape, heads, sm_count(x.device.index or 0))
    return (plan.group, plan.cols), empty if plan.fused else torch.empty_like(x)


def window_attn_block_fused(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                            window: int = WINDOW, eps: float = LN_EPS, packed=None):
    """``x + WindowMHSA(LN1(x))`` through Kernel E over ``x`` ``[P, H, W, C]``.

    CPU tensors take :func:`window_attn_block_torch`; CUDA tensors launch the
    kernel or raise. ``packed``, when given, is :func:`pack_attn` of the same
    weights in x's dtype on x's device (a caller's cache). In bfloat16 the
    call is two launches (:func:`attn_plan`) and allocates the scratch o.
    """
    if x.device.type == "cpu":
        return window_attn_block_torch(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                                       heads, window, eps)
    check_cuda_attn(x, (wq, wk, wv, wo), heads, window, "window_attn_block_fused")
    if x.numel() == 0:
        return torch.empty_like(x)
    if packed is None:
        packed = pack_attn(wq, bq, wk, bk, wv, bv, wo, bo, heads, x.dtype, x.device)
    plan, o = attn_launch_plan(x, heads)
    g, b = ln_f32(ln_w, ln_b, x.device)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    err = build.library().i2r_window_attn_fwd(
        xc.data_ptr(), g.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in packed), o.data_ptr(),
        out.data_ptr(), *x.shape, heads, *plan, float(eps), DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "window_attn_block kernel")
    window_attn_block_fused.launches += 1
    return out


def check_cuda_attn(x, projections, heads: int, window: int, what: str) -> None:
    """Raise unless ``x`` is a float32/bfloat16 ``[P, H, W, C]`` CUDA tensor the
    window-attention kernels take (7x7 windows, C split into ``heads``,
    ``[C, C]`` projections, a grid in range); shapes are checked first."""
    if x.dim() != 4 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"{what}: x must be float32 or bfloat16 [P, H, W, C], "
                         f"got {x.dtype} {tuple(x.shape)}")
    p, h, w, c = x.shape
    if window != WINDOW or heads < 1 or c % heads:
        raise ValueError(f"{what}: window {window} (kernel: {WINDOW}), "
                         f"C={c} must split into {heads} heads")
    if any(t.shape != (c, c) for t in projections):
        raise ValueError(f"{what}: projections must be [C, C] = {(c, c)}")
    nwin = -(-h // window) * -(-w // window)
    if nwin > 2 ** 31 - 1 or p > 65535 or h > 65535:
        raise ValueError(f"{what}: grid ({nwin}, {p}) out of range")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def ln_f32(ln_w, ln_b, device):
    """LayerNorm scale and bias as contiguous f32 on ``device``."""
    return tuple(t.detach().to(device, torch.float32).contiguous() for t in (ln_w, ln_b))


def mlp_block_fused(x, ln_w, ln_b, w1, b1, dw, bdw, w2, b2, eps: float = LN_EPS, packed=None):
    """``x + MlpDWBN(LN2(x))`` (folded BNs) through Kernel F over ``[P, H, W, C]``.

    CPU tensors take :func:`mlp_block_torch`; CUDA tensors launch the kernel
    or raise. ``packed``, when given, is :func:`pack_mlp` of the same weights
    in x's dtype on x's device. The launch follows
    :func:`~i2rnet_tpu_torch.ops.cuda.mlp_dwbn.launch_plan`; with several
    hidden slices it allocates their f32 sums.
    """
    if x.device.type == "cpu":
        return mlp_block_torch(x, ln_w, ln_b, w1, b1, dw, bdw, w2, b2, eps)
    check_cuda_mlp(x, w1, dw, w2, "mlp_block_fused")
    if x.numel() == 0:
        return torch.empty_like(x)
    if packed is None:
        packed = pack_mlp(w1, b1, dw, bdw, w2, b2, x.dtype, x.device)
    dh = packed[1].shape[0]
    plan, part = launch_plan(x, dh)
    g, b = ln_f32(ln_w, ln_b, x.device)
    xc = x.contiguous()
    out = torch.empty_like(xc)
    err = build.library().i2r_mlp_block_fwd(
        xc.data_ptr(), g.data_ptr(), b.data_ptr(), *(t.data_ptr() for t in packed),
        out.data_ptr(), part.data_ptr(), *x.shape, dh, *plan, float(eps), DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mlp_block kernel")
    mlp_block_fused.launches += 1
    return out


def full_block_torch(x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_w, ln2_b,
                     w1, b1, dw, bdw, w2, b2, heads: int, window: int = WINDOW,
                     eps: float = LN_EPS):
    """Plain PyTorch GeneralTransformerBlock with kernel 7's rounding:
    :func:`mlp_block_torch` of :func:`window_attn_block_torch` (one eps for
    both LayerNorms)."""
    xa = window_attn_block_torch(x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, window,
                                 eps)
    return mlp_block_torch(xa, ln2_w, ln2_b, w1, b1, dw, bdw, w2, b2, eps)


def full_block_fused(x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_w, ln2_b,
                     w1, b1, dw, bdw, w2, b2, heads: int, window: int = WINDOW,
                     eps: float = LN_EPS, packed=None):
    """One GeneralTransformerBlock through kernel 7 over ``x`` ``[P, H, W, C]``:
    Kernel E's then Kernel F's work in one cooperative launch, bit-equal to
    ``mlp_block_fused(window_attn_block_fused(x))``.

    CPU tensors take :func:`full_block_torch`; CUDA tensors launch the kernel
    or raise (a refused cooperative launch raises; nothing falls back to E
    then F). ``packed``, when given, is the pair (:func:`pack_attn`,
    :func:`pack_mlp`) of the same weights in x's dtype on x's device. Every map
    size takes the kernel: the JAX package's VMEM gate
    (``block_onepass_fits_vmem``, which sends 384x288's 96x72 branch-0 map to
    its two kernels) is a TPU limit, and both routes compute the same function.
    """
    if x.device.type == "cpu":
        return full_block_torch(x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_w, ln2_b,
                                w1, b1, dw, bdw, w2, b2, heads, window, eps)
    check_cuda_attn(x, (wq, wk, wv, wo), heads, window, "full_block_fused")
    check_cuda_mlp(x, w1, dw, w2, "full_block_fused")
    if x.numel() == 0:
        return torch.empty_like(x)
    if packed is None:
        packed = (pack_attn(wq, bq, wk, bk, wv, bv, wo, bo, heads, x.dtype, x.device),
                  pack_mlp(w1, b1, dw, bdw, w2, b2, x.dtype, x.device))
    (wqkv, bqkv, wot, bof, wf, wof), (w1p, b1f, dwt, bdwf, w2p, b2f) = packed
    plan, part = launch_plan(x, b1f.shape[0])  # part: the slices' sums, written and read
    attn, o = attn_launch_plan(x, heads)  # o: E's pass-1 output, written and read
    g1, be1 = ln_f32(ln1_w, ln1_b, x.device)
    g2, be2 = ln_f32(ln2_w, ln2_b, x.device)
    xc = x.contiguous()
    xa = torch.empty_like(xc)  # the attention half's output, written and read by the launch
    out = torch.empty_like(xc)
    ptrs = (xc, g1, be1, wqkv, bqkv, wot, bof, g2, be2, w1p, b1f, dwt, bdwf, w2p, b2f, wf, wof, o,
            xa, part, out)
    err = build.library().i2r_full_block_fwd(
        *(t.data_ptr() for t in ptrs), *x.shape, heads, b1f.shape[0], *attn, *plan, float(eps),
        DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "full_block kernel")
    full_block_fused.launches += 1
    return out


window_attn_block_fused.launches = 0
mlp_block_fused.launches = 0
full_block_fused.launches = 0
