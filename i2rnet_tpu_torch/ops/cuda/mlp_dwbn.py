"""Kernel G: the HRFormer MlpDWBN chain alone, BatchNorms folded (eval).

Replaces ``i2rnet_tpu/ops/pallas/mlp_dwbn.py::mlp_dwbn_fused``; the kernel is
``csrc/mlp_dwbn.cu`` (one templated source with Kernel F). :func:`mlp_dwbn_torch`
is its plain PyTorch version and follows the Pallas kernel's numerics
(``mlp_dwbn.py:73-95``): x, weights and the hidden map all in f32,

    h   = gelu(x . W1^T + b1)                 1x1 expand, C -> D
    h   = gelu(dw3x3(h) + bdw)                depthwise 3x3, zero border
    out = T(gelu(h . W2^T + b2))              1x1 contract, D -> C

with the Abramowitz-Stegun erf GELU (:func:`gelu_exact`) and one cast to the
input dtype T at the end. The kernel runs both products on the tensor cores
in three TF32 passes (:func:`tf32_rna`, :func:`pack_tf32x3`) under its launch
plan (:func:`mlp32_plan`). Also here, shared with Kernel F and kernel 7:
:func:`fold_bn`, the tanh-form GELU :func:`gelu_tanh_erf` (constants copied
from the JAX module), the weight packing of the shared source and F's launch
plan (:func:`mlp_plan`).

Layouts: ``x`` ``[P, H, W, C]``; ``w1`` ``[D, C]`` and ``w2`` ``[C, D]`` (a
1x1 convolution's weight without its 1x1), ``dw`` ``[D, 3, 3]`` (a depthwise
convolution's weight without its group axis); biases f32.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from i2rnet_tpu_torch import tracing
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

# F's bf16 tensor-core body, as ``csrc/mlp_dwbn.cuh`` and ``csrc/common.cuh``
# compile it (tests/test_torch_mlp_tiles.py reads the same constants there)
HIDDEN_CHUNK = 64  #: hidden channels per chunk (kHC)
TILE = 8  #: output tile edge before it is evened out over the map (at most kMaxTw)
TWO_PER_SM = 113 * 1024  #: shared memory that still fits two blocks per SM (kTwoPerSm)
MAX_SMEM = 232448  #: shared memory of one block (kMaxSmem)
#: row padding (floats) of G's f32 buffers (kPad32)
PAD32 = 4
#: the f32 sums of the hidden slices stay in the H100's 50 MB of L2
PARTIAL_LIMIT = 32 << 20


def fold_bn(weight, bias, mean, var, eps: float = BN_EPS):
    """(k, c) with ``BN(x) == x * k + c`` (eval statistics), in f32."""
    k = weight.float() * torch.rsqrt(var.float() + eps)
    return k, bias.float() - mean.float() * k


# torch.exp and torch.tanh go to MKL's vector math on the CPU, whose first
# multi-threaded call in a process returns, about one process in a hundred,
# values up to 9e-5 off on one thread's share of the tensor (measured with
# two threads on a [2, 18, 13, 32] f32 tensor: the second call agrees with
# float64 to 3e-8). torch.exp2 and torch.sigmoid run torch's own kernels and
# showed no such call, so the GELUs below are written with them.
_LOG2E = 1.4426950408889634


def _tanh(x):
    """tanh(x) = 2 sigmoid(2x) - 1 (see above)."""
    return 2.0 * torch.sigmoid(2.0 * x) - 1.0


def _erf(x):
    ax = x.abs()
    t = 1.0 / (1.0 + _AS_P * ax)
    a1, a2, a3, a4, a5 = _AS_A
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return torch.sign(x) * (1.0 - poly * torch.exp2(-ax * ax * _LOG2E))


def gelu_exact(x):
    """GELU with the Abramowitz-Stegun erf of the Pallas kernel (f32)."""
    return 0.5 * x * (1.0 + _erf(x * 0.7071067811865476))


def gelu_tanh_erf(x):
    """GELU with the tanh-form erf fit (f32), as ``_gelu_tanh_erf``."""
    c0, c1, c2, c3, c4 = GELU_TANH_C
    z = x * x
    p = x * (c0 + z * (c1 + z * (c2 + z * (c3 + z * c4))))
    return 0.5 * x * (1.0 + _tanh(p))


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


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def pad8(n: int) -> int:
    return -(-n // 8) * 8


def tf32_rna(x):
    """``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: f32 values whose 13 low mantissa
    bits are 0. Infinities and NaN pass; a value that rounds past the
    largest finite one becomes infinite."""
    x = x.float()
    bits = (x.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isfinite(x), bits.view(torch.float32), x)


def pack_tf32x3(m, n_pad: int, k_pad: int):
    """``m`` [N, K] as the B operand of ``mma.sync.m16n8k8`` in TF32 (K x N,
    "col"), split into hi = tf32(m) and lo = tf32(m - hi), fragment by
    fragment: ``[n_pad / 8, k_pad / 8, 32 lanes, 4]`` f32, where lane l of
    n-tile j and k-step kk holds ``(hi[r, q], hi[r, q + 4], lo[r, q], lo[r,
    q + 4])`` for r = 8j + l // 4, q = 8kk + l % 4 (registers b0, b1 of the
    two passes), zero past ``m``. A warp loads one fragment as 32
    consecutive 16-byte words."""
    n, k = m.shape
    padded = torch.zeros(n_pad, k_pad, dtype=torch.float32, device=m.device)
    padded[:n, :k] = m
    hi = tf32_rna(padded)
    lo = tf32_rna(padded - hi)

    def frag(a):  # [j, g, kk, half, t] -> [j, kk, g, t, half]
        a = a.reshape(n_pad // 8, 8, k_pad // 8, 2, 4).permute(0, 2, 1, 4, 3)
        return a.reshape(n_pad // 8, k_pad // 8, 32, 2)

    return torch.cat([frag(hi), frag(lo)], -1).contiguous()


def pack_fragments(m, n_pad: int, k_pad: int):
    """``m`` [..., N, K] bf16 as the B operand of ``mma.sync.m16n8k16`` (K x N,
    "col") fragment by fragment: ``[..., n_pad / 8, k_pad / 16, 32 lanes, 4]``,
    where lane l of n-tile j and k-step kk holds ``m[8j + l // 4, 16kk +
    2(l % 4) + (0, 1, 8, 9)]`` (its registers b0 and b1), zero past ``m``. A
    warp loads one fragment as 32 consecutive 8-byte words."""
    *lead, n, k = m.shape
    padded = torch.zeros(*lead, n_pad, k_pad, dtype=m.dtype, device=m.device)
    padded[..., :n, :k] = m
    frag = padded.reshape(*lead, n_pad // 8, 8, k_pad // 16, 2, 4, 2)
    b = len(lead)
    frag = frag.permute(*range(b), b, b + 2, b + 1, b + 4, b + 3, b + 5)
    return frag.reshape(*lead, n_pad // 8, k_pad // 16, 32, 4).contiguous()


def pack_mlp(w1, b1, dw, bdw, w2, b2, wdtype, device):
    """The kernels' weight layout on ``device``: the taps [3, 3, D] and the
    biases in f32; in float32 ``W1^T`` [C, D] and ``W2^T`` [D, C] (the
    CUDA-core template), in bfloat16 W1 [D, C] and W2 [C, D] as tensor-core
    fragments (:func:`pack_fragments`; D padded to a multiple of
    ``HIDDEN_CHUNK``, C to 16)."""
    if wdtype == torch.bfloat16:
        (d, c), dp = w1.shape, -(-w1.shape[0] // HIDDEN_CHUNK) * HIDDEN_CHUNK
        w1p = pack_fragments(w1.detach().to(device, wdtype), dp, pad16(c))
        w2p = pack_fragments(w2.detach().to(device, wdtype), pad16(c), dp)
    else:
        w1p = w1.detach().to(device, wdtype).t().contiguous()
        w2p = w2.detach().to(device, wdtype).t().contiguous()
    b1f, dwt, bdwf, b2f = _f32_vectors(b1, dw, bdw, b2, device)
    return w1p, b1f, dwt, bdwf, w2p, b2f


def _f32_vectors(b1, dw, bdw, b2, device):
    """b1, the taps [3, 3, D], bdw and b2 in f32 on ``device``."""
    dwt = dw.detach().to(device, torch.float32).permute(1, 2, 0).contiguous()
    b1f, bdwf, b2f = (t.detach().to(device, torch.float32).contiguous() for t in (b1, bdw, b2))
    return b1f, dwt, bdwf, b2f


def pack_mlp32(w1, b1, dw, bdw, w2, b2, device):
    """Kernel G's weight layout on ``device``, in :func:`pack_mlp`'s order:
    W1 [D, C] and W2 [C, D] as TF32 hi/lo fragments (:func:`pack_tf32x3`; D
    padded to a multiple of ``HIDDEN_CHUNK``, C to 8), the taps [3, 3, D] and
    the biases in f32."""
    d, c = w1.shape
    dp = -(-d // HIDDEN_CHUNK) * HIDDEN_CHUNK
    w1p = pack_tf32x3(w1.detach().to(device, torch.float32), dp, pad8(c))
    w2p = pack_tf32x3(w2.detach().to(device, torch.float32), pad8(c), dp)
    b1f, dwt, bdwf, b2f = _f32_vectors(b1, dw, bdw, b2, device)
    return w1p, b1f, dwt, bdwf, w2p, b2f


@dataclass(frozen=True)
class MlpPlan:
    """Kernel F's or G's launch over one ``[P, H, W, C]`` map with D hidden
    channels (kernel 7's second phase takes F's): output tiles ``th`` x ``tw``,
    row-major; ``slices`` hidden slices, each summed by its own block; grid
    (tiles, slices, P); ``smem`` bytes of shared memory a block; ``partial_bytes``
    of f32 slice sums in device memory (0 with one slice)."""

    p: int
    h: int
    w: int
    c: int
    dh: int
    th: int
    tw: int
    slices: int
    smem: int

    @property
    def tiles(self) -> int:
        return -(-self.h // self.th) * -(-self.w // self.tw)

    @property
    def grid(self) -> tuple:
        return self.tiles, self.slices, self.p

    @property
    def blocks(self) -> int:
        return self.tiles * self.slices * self.p

    @property
    def partial_bytes(self) -> int:
        return 4 * self.slices * self.p * self.h * self.w * self.c if self.slices > 1 else 0

    def tile_pixels(self, tile: int):
        """(rows, cols) of the map that output tile ``tile`` writes."""
        tiles_w = -(-self.w // self.tw)
        oy, ox = tile // tiles_w * self.th, tile % tiles_w * self.tw
        return range(oy, min(oy + self.th, self.h)), range(ox, min(ox + self.tw, self.w))

    def slice_channels(self, s: int) -> range:
        """The hidden channels slice ``s`` sums: whole chunks of
        ``HIDDEN_CHUNK``, slice s taking chunks [s n / S, (s + 1) n / S)."""
        n = -(-self.dh // HIDDEN_CHUNK)
        lo, hi = s * n // self.slices, (s + 1) * n // self.slices
        return range(lo * HIDDEN_CHUNK, min(hi * HIDDEN_CHUNK, self.dh))


def _mma_smem(c, h, w, th, tw, dh, slices):
    """``mlp_dwbn.cuh::mlp_mma_smem_bytes``: the LN'd tile + halo (cut to the
    map), the expanded chunk, the slice after the depthwise conv; bf16."""
    box, chunks = pad16(min(th + 2, h) * min(tw + 2, w)), -(-dh // HIDDEN_CHUNK)
    per = -(-chunks // slices)  # chunks of the largest slice
    return 2 * (box * (pad16(c) + 8) + box * (HIDDEN_CHUNK + 8)
                + pad16(th * tw) * (per * HIDDEN_CHUNK + 8))


def _mma32_smem(c, h, w, th, tw, dh, slices):
    """``mlp_dwbn.cuh::mlp32_smem_bytes``: G's x of tile + halo (cut to the
    map, channels padded to 8), the expanded chunk, the slice after the
    depthwise conv; f32 rows padded by ``PAD32``."""
    box, chunks = pad16(min(th + 2, h) * min(tw + 2, w)), -(-dh // HIDDEN_CHUNK)
    per = -(-chunks // slices)  # chunks of the largest slice
    return 4 * (box * (pad8(c) + PAD32) + box * (HIDDEN_CHUNK + PAD32)
                + pad16(th * tw) * (per * HIDDEN_CHUNK + PAD32))


#: (shared-memory limit, tile height, tile width) in the order the plans try
#: them: F's, and G's, which keeps two blocks per SM with half-height tiles
#: before it settles for one (on the H100, branch 1 of 256x192 at P=32:
#: 837.5 us against 958.4 with 8x8 tiles at one block per SM,
#: probes/mlp32_probe.py), and takes 4x4 tiles where its f32 box of 8x8
#: fits no block (C = 624 on a 16x12 map)
F_TILES = ((TWO_PER_SM, TILE, TILE), (MAX_SMEM, TILE, TILE))
G_TILES = ((TWO_PER_SM, TILE, TILE), (TWO_PER_SM, TILE // 2, TILE), (MAX_SMEM, TILE, TILE),
           (MAX_SMEM, TILE // 2, TILE // 2))


def _plan(p, h, w, c, dh, sms, smem, tiles, what):
    """The launch plan both bodies share (:func:`mlp_plan`) with the body's
    shared memory ``smem(c, h, w, th, tw, dh, slices)`` and its ``tiles``."""
    chunks = -(-dh // HIDDEN_CHUNK)
    for limit, eh, ew in tiles:
        th, tw = -(-h // -(-h // eh)), -(-w // -(-w // ew))  # eh x ew tiles, evened out
        fits = [s for s in range(1, chunks + 1) if smem(c, h, w, th, tw, dh, s) <= limit]
        if fits:
            break
    else:
        raise ValueError(f"the {what} MlpDWBN kernel does not fit C={c} in {MAX_SMEM} B")
    slices = fits[0]
    while (-(-h // th) * -(-w // tw) * slices * p < 2 * sms and slices < chunks
           and 4 * (slices + 1) * p * h * w * c <= PARTIAL_LIMIT):
        slices += 1
    return MlpPlan(p, h, w, c, dh, th, tw, slices, smem(c, h, w, th, tw, dh, slices))


@functools.lru_cache(maxsize=None)
def mlp_plan(p: int, h: int, w: int, c: int, dh: int, sms: int = 132) -> MlpPlan:
    """Kernel F's bf16 launch plan for ``p`` maps ``[h, w, c]`` with ``dh``
    hidden channels on a card with ``sms`` SMs: ``TILE`` x ``TILE`` output
    tiles evened out over the map (a smaller map is one tile), the fewest
    hidden slices that keep two blocks per SM in shared memory (or one block
    where two never fit), then one more slice at a time while the grid holds
    fewer than two blocks per SM, up to one slice per chunk and
    ``PARTIAL_LIMIT`` bytes of slice sums. Raises ValueError where one block
    does not fit (a width of about a thousand channels). The float32 instances keep the CUDA-core template, which
    picks its own tile (``mlp_dwbn.cuh::mlp_tile``) and takes one slice.
    """
    return _plan(p, h, w, c, dh, sms, _mma_smem, F_TILES, "bf16")


@functools.lru_cache(maxsize=None)
def mlp32_plan(p: int, h: int, w: int, c: int, dh: int, sms: int = 132) -> MlpPlan:
    """Kernel G's launch plan, as :func:`mlp_plan` with G's f32 buffers
    (:func:`_mma32_smem`) and ``G_TILES``, which tries 4x8 tiles at two
    blocks per SM before 8x8 at one: at 256x192's four branch maps (P=32)
    8x8 tiles with 3 slices, 4x8 with 2, 4x6 with 4 (all two blocks per
    SM), then 8x6 with 8 slices at one block per SM. Raises ValueError where
    one block does not fit (C past about 1100)."""
    return _plan(p, h, w, c, dh, sms, _mma32_smem, G_TILES, "TF32")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def device_plan(x, dh: int) -> MlpPlan:
    """:func:`mlp_plan` for bf16 ``x`` ``[P, H, W, C]`` on its CUDA device."""
    p, h, w, c = x.shape
    return mlp_plan(p, h, w, c, dh, sm_count(x.device.index or 0))


def launch_plan(x, dh: int):
    """``(th, tw, slices)`` of F's launch over ``x`` ``[P, H, W, C]`` (kernel
    7's second phase too) and the f32 scratch of the slices' sums, empty
    with one slice: :func:`device_plan` in bfloat16; ``(0, 0, 1)`` in
    float32, where the CUDA-core template picks its own tile."""
    if x.dtype != torch.bfloat16:
        return (0, 0, 1), torch.empty(0, dtype=torch.float32, device=x.device)
    plan = device_plan(x, dh)
    part = torch.empty(plan.partial_bytes // 4, dtype=torch.float32, device=x.device)
    return (plan.th, plan.tw, plan.slices), part


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


def mlp_dwbn_fused(x, w1, b1, dw, bdw, w2, b2, packed=None):
    """MlpDWBN (folded BNs) through Kernel G over ``x`` ``[P, H, W, C]``.

    CPU tensors take :func:`mlp_dwbn_torch`; CUDA tensors launch the kernel
    (under :func:`mlp32_plan`) or raise. ``packed``, when given, is
    :func:`pack_mlp32` of the same weights on x's device (a caller's cache).
    """
    if x.device.type == "cpu":
        return mlp_dwbn_torch(x, w1, b1, dw, bdw, w2, b2)
    check_cuda_mlp(x, w1, dw, w2, "mlp_dwbn_fused")
    if x.numel() == 0:
        return torch.empty_like(x)
    p, h, w, c = x.shape
    d = w1.shape[0]
    if packed is None:
        packed = pack_mlp32(w1, b1, dw, bdw, w2, b2, x.device)
    n1, n2 = -(-d // HIDDEN_CHUNK) * HIDDEN_CHUNK // 8, pad8(c) // 8
    if (tuple(packed[0].shape), tuple(packed[4].shape)) != ((n1, n2, 32, 4), (n2, n1, 32, 4)):
        raise ValueError("mlp_dwbn_fused: packed weights are not pack_mlp32's layout for "
                         f"C={c}, D={d}")
    plan = mlp32_plan(p, h, w, c, d, sm_count(x.device.index or 0))
    xc = x.contiguous()
    out = torch.empty_like(xc)
    part = torch.empty(plan.partial_bytes // 4, dtype=torch.float32, device=x.device)
    err = build.library().i2r_mlp_dwbn_fwd(
        xc.data_ptr(), *(t.data_ptr() for t in packed), out.data_ptr(), part.data_ptr(), p, h, w,
        c, d, plan.th, plan.tw, plan.slices, DTYPE_CODES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "mlp_dwbn kernel")
    tracing.count("kernel.mlp_dwbn")
    return out
