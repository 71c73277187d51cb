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
* backward (``csrc/window_attn_block_train.cu``), in bfloat16 five launches
  laid out by :func:`attn_bwd_plan`: pass 1, K1 per (window, head group,
  person) on the tensor cores (``da2 = T(s * dy)``, dO, q/k/v recomputed
  with the forward's fragments, the attention backward; o and ``T(dQ)``,
  ``T(dK)``, ``T(dV)`` to token arrays, the bias sums per window); pass 2,
  ``dt2 = T([T(dQ) T(dK) T(dV)] . Wqkv)`` per (64 token rows, column
  block); K2, the LayerNorm backward per row of pixels, ``dx = dy +
  T(LN1'(dt2))``; the four weight gradients in row slices; one fixed-order
  sum of the slices and of the bias and LayerNorm partials. float32 keeps
  the first CUDA-core template (K1 per (window, person), K2, the weight
  gradients by ``common.cuh::outer_sum``). K1 rounds where
  ``_attn_bwd_kernel`` rounds (:163-240): ``doh``, ``dsb`` and
  ``dq3b``/``dk3b``/``dv3b`` in T before their products, dt2 once after one
  f32 sum over the heads; the bias gradients sum the f32 values.

Gradients come back in the torch ``Linear`` layouts, f32, the 1/sqrt(d) fold
undone on ``dWq`` and ``dbq`` (``unpack_head_grads``, :295-318). The weight
layout is Kernel E's :func:`~.hrformer_block.pack_attn`.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (LN_EPS, MAX_COLS, MAX_DP, ROWS, WINDOW,
                                                      attn_launch_plan, check_cuda_attn, ln_f32,
                                                      pack_attn, window_attn_f32)
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import (DTYPE_CODES, MAX_SMEM, pack_fragments, pad16,
                                                sm_count)

#: float32 route: row slices of the weight-gradient reduction (``csrc/common.cuh``)
W_SPLITS = 16
# the bf16 backward, as ``csrc/window_attn_block_train.cu`` compiles it
# (tests/test_torch_attn_bwd_tiles.py reads the same constants there)
P_LD = ROWS + 8  #: row stride of pass 1's T(P) and T(dS) tiles (kPLd)
K_CHUNK = 256  #: columns of pass 2's row tile a stage (kKChunk)
W_TILE = 64  #: weight-gradient tile edge, and token rows a stage (kWTile)
W_STAGES = 2  #: stages of the weight gradients' cp.async ring (kWStages)
TWO_PER_SM = 113 * 1024  #: shared memory of a block that still fits two per SM (kTwoPerSm)
W_PRODUCTS = 4  #: dWq, dWk, dWv, dWo (kWProducts)


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


def attn_bwd_fragments(wqkv, wot):
    """The bf16 backward's weights from :func:`~.hrformer_block.pack_attn`'s
    ``Wqkv`` [C, heads, 3, d] and ``Wo^T`` [C, C], as mma B-operand fragments
    (:func:`~.mlp_dwbn.pack_fragments`): for pass 1's dO, per head the [dp, C]
    rows of ``Wo^T`` of its inputs (dp = d padded to 16, zero past d; k over
    the C outputs, padded to 16), ``[heads, dp / 8, pad16(C) / 16, 32, 4]``;
    for pass 2's dt2, the [C, 3 heads dp] matrix whose column (m heads + hd) dp
    + j is ``Wqkv[:, hd, m, j]`` (zero past d), ``[pad16(C) / 8, 3 heads dp /
    16, 32, 4]``."""
    c, heads, _, d = wqkv.shape
    dp, cp = pad16(d), pad16(c)
    wdo = pack_fragments(wot.reshape(heads, d, c), dp, cp)
    cols = torch.zeros(c, 3, heads, dp, dtype=wqkv.dtype, device=wqkv.device)
    cols[..., :d] = wqkv.permute(0, 2, 1, 3)
    return wdo, pack_fragments(cols.reshape(c, 3 * heads * dp), cp, 3 * heads * dp)


@dataclass(frozen=True)
class AttnBwdPlan:
    """The bf16 backward's launches over ``p`` maps ``[h, w, c]`` of ``heads``
    heads. Pass 1, a block per (window, head group of ``group`` heads,
    person), grid (windows x groups, P), window = blockIdx.x % windows; pass
    2, a block per (64 token rows, ``cols`` 8-column n-tiles of dt2's
    pad16(c) / 8), grid (row blocks, column blocks); the weight gradients, a
    block per (64 x 64 tile, row slice), the q/k/v products' tiles (three
    products each) then dWo's, grid (tiles, ``nz``) with ``per`` token rows
    a slice. ``smem1``, ``smem2``, ``smem_w``: bytes of
    shared memory a block of each."""

    p: int
    h: int
    w: int
    c: int
    heads: int
    group: int
    cols: int
    slices: int

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
    def rows(self) -> int:
        """Token rows: P windows of 49."""
        return self.p * self.windows * WINDOW * WINDOW

    @property
    def kdim(self) -> int:
        """Columns of a token's T(dQ), T(dK), T(dV) row: (m, head, j) padded."""
        return 3 * self.heads * pad16(self.d)

    @property
    def grid1(self) -> tuple:
        return self.windows * self.groups, self.p

    @property
    def ntiles(self) -> int:
        return pad16(self.c) // 8

    @property
    def grid2(self) -> tuple:
        return -(-self.rows // ROWS), -(-self.ntiles // self.cols)

    @property
    def w_tiles(self) -> tuple:
        """(q/k/v row tiles, column tiles) of a weight-gradient product."""
        return -(-self.heads * pad16(self.d) // W_TILE), -(-self.c // W_TILE)

    @property
    def per(self) -> int:
        return -(-(-(-self.rows // self.slices)) // W_TILE) * W_TILE

    @property
    def grid_w(self) -> tuple:
        ntq, ntn = self.w_tiles
        return ntq * ntn + ntn * ntn, -(-self.rows // self.per)

    @property
    def part_shape(self) -> tuple:
        """The f32 slice sums: [slices, 4, mmax, nmax]."""
        ntq, ntn = self.w_tiles
        return self.slices, W_PRODUCTS, max(ntq, ntn) * W_TILE, ntn * W_TILE

    @property
    def blocks1(self) -> int:
        return self.grid1[0] * self.grid1[1]

    @property
    def blocks2(self) -> int:
        return self.grid2[0] * self.grid2[1]

    @property
    def blocks_w(self) -> int:
        return self.grid_w[0] * self.grid_w[1]

    @property
    def smem1(self) -> int:
        return bwd1_smem(self.c, self.d, self.group)

    @property
    def smem2(self) -> int:
        """``bwd2_smem_bytes``: two stages of a [64][K_CHUNK + 8] bf16 row tile."""
        return 2 * 2 * ROWS * (K_CHUNK + 8)

    @property
    def smem_w(self) -> int:
        """``bwd_w_smem_bytes``: W_STAGES stages of four [64][72] bf16 tiles."""
        return 2 * W_STAGES * 4 * W_TILE * (W_TILE + 8)

    def group_heads(self, hg: int) -> range:
        return range(hg * self.group, (hg + 1) * self.group)

    def col_tiles(self, cb: int) -> range:
        """The n-tiles (8 output columns each) of column block ``cb``."""
        return range(cb * self.cols, min((cb + 1) * self.cols, self.ntiles))

    def slice_rows(self, z: int) -> range:
        return range(z * self.per, min((z + 1) * self.per, self.rows))


def bwd1_smem(c: int, d: int, group: int) -> int:
    """``window_attn_block_train.cu::bwd1_smem_bytes``: the window tile (or
    the T(P), T(dS) tiles in its bytes), q, k, v and the group's dO (bf16),
    the bias sums [4][3][dp] (f32), the tokens' map coordinates."""
    region = 2 * ROWS * max(pad16(c) + 8, 2 * P_LD)
    return region + 2 * ROWS * (pad16(d) + 8) * (3 + group) + 4 * 12 * pad16(d) + 4 * 2 * ROWS


@functools.lru_cache(maxsize=None)
def attn_bwd_plan(p: int, h: int, w: int, c: int, heads: int, sms: int = 132) -> AttnBwdPlan:
    """The bf16 backward's launch plan on a card with ``sms`` SMs. Pass 1:
    the largest head group (a divisor of ``heads``) whose grid holds two
    blocks per SM and whose shared memory fits two blocks on an SM, down to
    one head a block (as :func:`~.hrformer_block.attn_plan`, which has no
    dO tiles to hold). Pass 2: column blocks of at most ``MAX_COLS``
    n-tiles, split evenly until its grid holds two blocks per SM or each
    block has one n-tile. Weight gradients: row slices until the grid holds
    two blocks per SM, each slice at least one stage of ``W_TILE`` rows.
    Raises ValueError where the head dim padded to 16 exceeds ``MAX_DP`` or
    pass 1's shared memory ``MAX_SMEM``. The float32 instances keep the
    CUDA-core template (no plan)."""
    d = c // heads
    if pad16(d) > MAX_DP:
        raise ValueError(f"the bf16 window-attention backward takes head dims up to {MAX_DP}, "
                         f"got {d}")
    windows = -(-h // WINDOW) * -(-w // WINDOW)
    divisors = [g for g in range(heads, 0, -1) if heads % g == 0]
    group = next((g for g in divisors if windows * (heads // g) * p >= 2 * sms
                  and bwd1_smem(c, d, g) <= TWO_PER_SM), 1)
    if bwd1_smem(c, d, group) > MAX_SMEM:
        raise ValueError(f"the bf16 window-attention backward does not fit C={c} in "
                         f"{MAX_SMEM} B")
    rows = p * windows * WINDOW * WINDOW
    ntiles, row_blocks = pad16(c) // 8, -(-rows // ROWS)
    splits = max(-(-ntiles // MAX_COLS), min(ntiles, -(-2 * sms // row_blocks)))
    ntq, ntn = -(-heads * pad16(d) // W_TILE), -(-c // W_TILE)
    slices = min(max(1, -(-2 * sms // (ntq * ntn + ntn * ntn))), -(-rows // W_TILE))
    return AttnBwdPlan(p, h, w, c, heads, group, -(-ntiles // splits), slices)


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
    tracing.count("kernel.window_attn_block_train_fwd")
    return out, t2


def window_attn_train_bwd(x, dy, s, t2, ln, packed, heads: int, eps: float):
    """Launch the backward; ``packed`` holds ``(Wqkv, bqkv, Wo^T, wf, wdo,
    wdt)``: :func:`~.hrformer_block.pack_attn`'s first three tensors and its
    q/k/v fragments, and :func:`attn_bwd_fragments` (the last three empty in
    float32). In bfloat16 the launches follow :func:`attn_bwd_plan` on x's
    device. Returns ``(dx, dln_w, dln_b, dwq, dbq, dwk, dbk, dwv, dbv, dwo,
    dbo)``, dx in x's dtype, the rest f32 in the torch layouts."""
    p, h, w, c = x.shape
    g, _ = ln
    dev, dt = x.device, x.dtype
    nwin = _nwin(h, w)
    rows = p * nwin * WINDOW * WINDOW
    if dt == torch.bfloat16:
        plan = attn_bwd_plan(p, h, w, c, heads, sm_count(dev.index or 0))
        tokens = torch.empty(3, rows, c, device=dev, dtype=dt)  # da2, o, dt2
        dqkv = torch.empty(rows, plan.kdim, device=dev, dtype=dt)  # T(dQ), T(dK), T(dV)
        w_part = torch.empty(plan.part_shape, device=dev)
        launch = (plan.group, plan.cols, plan.slices)
    else:
        tokens = torch.empty(6, rows, c, device=dev, dtype=dt)  # da2, o3, dq, dk, dv, dt2
        dqkv = torch.empty(0, device=dev, dtype=dt)
        w_part = torch.empty(W_SPLITS, c, c, device=dev)
        launch = (0, 0, 0)
    dx = torch.empty_like(x)
    bias_part = torch.empty(p * nwin, 4 * c, device=dev)
    ln_part = torch.empty(p * h, 2 * c, device=dev)
    d_vec = torch.empty(6 * c, device=dev)  # dbq, dbk, dbv, dbo, dln_w, dln_b
    dw = torch.empty(4, c, c, device=dev)   # dwq, dwk, dwv, dwo
    ptrs = (x, dy, s, t2, g, *packed, dx, tokens, dqkv, bias_part, ln_part, w_part, d_vec, dw)
    err = build.library().i2r_window_attn_train_bwd(
        *(t.data_ptr() for t in ptrs), p, h, w, c, heads, *launch, float(eps),
        1.0 / math.sqrt(c // heads), DTYPE_CODES[dt], _stream(x))
    build.check(err, "window_attn_block_train backward kernels")
    tracing.count("kernel.window_attn_block_train_bwd")
    dbq, dbk, dbv, dbo, dln_w, dln_b = torch.split(d_vec, c)
    return dx, dln_w, dln_b, dw[0], dbq, dw[1], dbk, dw[2], dbv, dw[3], dbo


class _WindowAttnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, eps):
        xc = x.contiguous()
        sf = s.detach().to(x.device, torch.float32).contiguous()
        ln = ln_f32(ln_w, ln_b, x.device)
        packed = pack_attn(wq, bq, wk, bk, wv, bv, wo, bo, heads, x.dtype, x.device)
        out, t2 = window_attn_train_fwd(xc, sf, ln, packed, heads, eps)
        wqkv, bqkv, wot, _, wf, _ = packed
        if x.dtype == torch.bfloat16:
            bwd = attn_bwd_fragments(wqkv, wot)
        else:
            bwd = (torch.empty(0, dtype=x.dtype, device=x.device),) * 2
        ctx.save_for_backward(xc, sf, t2, *ln, wqkv, bqkv, wot, wf, *bwd)
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
