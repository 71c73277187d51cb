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

In bfloat16 the kernel runs the tensor-core tile body ``csrc/ffn_tile.cuh``,
which Kernel D shares; :func:`ffn_plan` is its launch plan. The float32
instance keeps the CUDA-core template.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import MAX_SMEM, sm_count

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ROWS_PER_BLOCK = 8  # the f32 template: one row per warp per step
_F32_WARPS = 8  # warps of a block of the f32 templates (common.cuh kWarps)

# the bf16 tile body's constants (csrc/ffn_tile.cuh; tests/test_torch_ffn_tiles.py
# reads the same constants there)
UNIT = 16  #: rows a warp takes at a time, the mma's m (kUnit)
TILE_WARPS = 4  #: warps of a block of the forward and of the backward's pass 1 (kTileWarps)
TILE_ROWS = UNIT * TILE_WARPS  #: rows of a block's x tile, a unit a warp (kRows)
CHUNK = 64  #: hidden columns a step of the two products (kChunk)
MAX_CP = 256  #: C, at most (kMaxCp)
#: the padded widths of the instances above 128 (``inst_cp``): C rounds up to the next
WIDE_CP = (176, 192, 256)
W_TILE = 64  #: weight-gradient tile edge and token rows a stage of pass 2 (kWTile)
TWO_PER_SM = 113 * 1024  #: shared memory of a block that still fits two per SM (kTwoPerSm)


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def inst_cp(c: int) -> int:
    """The padded width of the bf16 instance that takes C (``ffn_tile.cuh::
    inst_cp``): C padded to 16 up to 128, else the next of ``WIDE_CP``."""
    cp = _up(c, 16)
    return cp if cp <= 128 else next((w for w in WIDE_CP if w >= c), _up(c, 16))


@dataclass(frozen=True)
class FfnPlan:
    """The bf16 FFN tail's launches over ``rows`` rows of width ``c`` with
    ``f`` hidden units: C padded to its instance's width (``cp``,
    :func:`inst_cp`; ``cp64`` that rounded up to 64) and F to 64 (``fp``); ``grid`` blocks of the forward and ``bwd_grid``
    of the backward's pass 1, whose warps take the ``units`` units of ``UNIT``
    rows in turn (unit u to block u % grid, then to its next warp); pass 2's
    ``slices`` row slices of ``slice_rows`` rows each."""

    rows: int
    c: int
    f: int
    cp: int
    fp: int
    cp64: int
    units: int
    fwd_smem: int
    bwd_smem: int
    grid: int
    bwd_grid: int
    slices: int
    slice_rows: int

    @property
    def dw_blocks(self) -> int:
        """Pass 2's blocks a slice: the 64 x 64 tiles of dW1 and dW2."""
        return 2 * (self.fp // W_TILE) * (self.cp64 // W_TILE)

    @property
    def part_numel(self) -> int:
        """f32 elements of pass 2's partial sums: [slices, 2, fp * cp64]."""
        return self.slices * 2 * self.fp * self.cp64


def ffn_smem(cp: int, fp: int, backward: bool) -> int:
    """Shared memory of the forward (or of the backward's pass 1), as
    ``fwd_smem``/``bwd_smem`` in ``csrc/ffn_tile.cuh``."""
    fwd = 2 * (fp * (cp + 8) + cp * (fp + 8) + TILE_ROWS * (cp + 8)) + 4 * (fp + 5 * cp)
    return fwd + (4 * TILE_WARPS * (fp // CHUNK) * 32 + 4 * TILE_WARPS * (5 * cp + fp)
                  if backward else 0)


def ffn_plan(rows: int, c: int, f: int, sms: int = 132, backward: bool = False) -> FfnPlan:
    """The bf16 launch plan on a card with ``sms`` SMs: the forward and pass
    1 as many blocks as units, up to two per SM where a block's shared
    memory fits two (one otherwise), so that the units spread over every SM;
    pass 2 row slices of whole ``W_TILE`` stages, as many as its grid needs
    to hold two blocks per SM. Raises ValueError where C exceeds ``MAX_CP``
    or the forward's (with ``backward``, pass 1's)
    shared memory exceeds ``MAX_SMEM``: the float32 template is no stand-in."""
    cp, fp = inst_cp(c), _up(f, CHUNK)
    fwd, bwd = ffn_smem(cp, fp, False), ffn_smem(cp, fp, True)
    if c > MAX_CP:
        raise ValueError(f"the bf16 FFN kernel takes C up to {MAX_CP}, got C={c}")
    need = bwd if backward else fwd
    if need > MAX_SMEM:
        raise ValueError(f"the bf16 FFN kernel does not fit C={c}, F={f}: {need} B of shared "
                         f"memory, the limit is {MAX_SMEM} B")
    units = -(-rows // UNIT)
    cp64 = _up(cp, W_TILE)
    dw_blocks = 2 * (fp // W_TILE) * (cp64 // W_TILE)
    slice_rows = max(W_TILE, rows // -(-2 * sms // dw_blocks) // W_TILE * W_TILE)
    return FfnPlan(rows, c, f, cp, fp, cp64, units, fwd, bwd,
                   min(units, (2 if fwd <= TWO_PER_SM else 1) * sms),
                   min(units, (2 if bwd <= TWO_PER_SM else 1) * sms),
                   -(-rows // slice_rows), slice_rows)


def f32_smem(c: int, f: int) -> int:
    """Shared memory of Kernel B's f32 template (``encoder_ffn.cu::smem_bytes``):
    W1^T and W2^T, the vectors and the warps' scratch, all f32."""
    return 4 * (2 * c * f + f + 5 * c + _F32_WARPS * (2 * c + f))


def check_f32_fits(c: int, f: int, need: int, what: str) -> None:
    """Raise where an f32 template's block needs more than ``MAX_SMEM``: its
    f32 weights stay whole in shared memory (147 KB at C = 96, F = 192;
    295 KB at C = F = 192, the cat_vec width), and no other route stands in."""
    if need > MAX_SMEM:
        raise ValueError(f"the float32 {what} kernel does not fit C={c}, F={f}: its f32 "
                         f"weights take {need} B of shared memory, the limit is {MAX_SMEM} B; "
                         "run that width in bfloat16")


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
    or raise (in bfloat16 where :func:`ffn_plan` refuses C or F, in float32
    where :func:`check_f32_fits` does).
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
    # f32 as the kernel takes them (no copy where they already are; the bf16
    # body rounds the weights as it loads them)
    params = [p.detach().to(x.device, torch.float32).contiguous()
              for p in (n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias)]
    x2 = x.reshape(-1, c).contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    if rows == 0:
        return out.reshape(x.shape)
    sms = sm_count(x.device.index or 0)
    if x.dtype == torch.float32:
        check_f32_fits(c, f, f32_smem(c, f), "encoder_ffn")
    grid = (ffn_plan(rows, c, f, sms).grid if x.dtype == torch.bfloat16
            else min(-(-rows // _ROWS_PER_BLOCK), 2 * sms))
    err = build.library().i2r_encoder_ffn_fwd(
        x2.data_ptr(), *(p.data_ptr() for p in params), out.data_ptr(),
        rows, c, f, float(eps), _DTYPE_CODES[x.dtype], grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "encoder_ffn kernel")
    tracing.count("kernel.encoder_ffn")
    return out.reshape(x.shape)
