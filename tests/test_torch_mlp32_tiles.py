"""The algorithm of Kernel G's tensor-core body, and its launch plan, on the CPU.

``csrc/mlp_dwbn.cuh::mlp_item_tf32x3`` (Kernel G) walks each person's map as
Kernel F's bf16 body does, in output tiles with their 1-pixel halo cut to the
map and the D hidden channels in slices of 64-channel chunks, but with f32
buffers and both 1x1 products as ``mma.sync.m16n8k8`` in TF32 with f32 sums,
three passes per k-step of 8: a_lo b_hi, a_hi b_lo, a_hi b_hi, where hi =
tf32(v) and lo = tf32(v - hi) (``cvt.rna``: to nearest, ties away from
zero). W1 and W2 are split once by the wrapper (``pack_tf32x3``); the A
operand is split as it is read. The slices' f32 sums are added in the order
s = 0 ... S-1 before + b2, GELU and the cast. The CUDA kernel runs only on
the card; :func:`tile_mlp32` is that walk in a few lines of torch, held
against the port's plain version (``mlp_dwbn_torch``) and the JAX Pallas
kernel (interpret mode) on the same numpy inputs, under
``ops/cuda/mlp_dwbn.py::mlp32_plan``.

Tolerance: 1e-5 of max|ref| in f32. Three passes leave out a_lo b_lo and
lo's own rounding, about 2^-21 of each product, far below the f32 sums'
own noise over hundreds of terms; one pass (hi only) keeps 11 bits of each
operand, about 2^-11 of each product, and misses that bound by an order of
magnitude, which is why the body splits.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from i2rnet_tpu.ops.pallas.mlp_dwbn import mlp_dwbn_fused as jax_mlp_dwbn
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import (HIDDEN_CHUNK, MAX_SMEM, PAD32, PARTIAL_LIMIT,
                                                TILE, TWO_PER_SM, _mma32_smem, gelu_exact,
                                                mlp32_plan, mlp_dwbn_torch, pack_mlp32,
                                                pack_tf32x3, pad8, pad16, tf32_rna)

torch.set_num_threads(2)

TOL = 1e-5  # of max|ref|, float32
#: HRFormer-B's four branch maps of a 256x192 input (H, W, C)
BRANCH_MAPS = [(64, 48, 78), (32, 24, 156), (16, 12, 312), (8, 6, 624)]


def _split(a):
    hi = tf32_rna(a)
    return hi, tf32_rna(a - hi)


def _mm_tf32(a, b, passes=3):
    """``a @ b`` as the body sums it: over k-steps of 8 in order, each adding
    a_lo b_hi, a_hi b_lo, then a_hi b_hi to the f32 sum (``passes=1``: a_hi
    b_hi alone)."""
    (ahi, alo), (bhi, blo) = _split(a), _split(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1])
    for k in range(0, a.shape[-1], 8):
        ks = slice(k, k + 8)
        if passes == 3:
            acc = acc + alo[..., ks] @ bhi[ks]
            acc = acc + ahi[..., ks] @ blo[ks]
        acc = acc + ahi[..., ks] @ bhi[ks]
    return acc


def tile_mlp32(x, w1, b1, dw, bdw, w2, b2, plan, passes=3):
    """MlpDWBN ``[P, H, W, C]`` as Kernel G's body walks it under ``plan``:
    x, weights and hidden maps f32, one cast to x's dtype at the end."""
    p, h, w, c = x.shape
    pc = pad8(c) - c  # channels past C: zero products
    xf, w1p, w2p = F.pad(x.float(), (0, pc)), F.pad(w1, (0, pc)), F.pad(w2, (0, 0, 0, pc))
    part = torch.zeros(plan.slices, p, h, w, c + pc)
    for tile in range(plan.tiles):
        rows, cols = plan.tile_pixels(tile)
        br = slice(max(rows.start - 1, 0), min(rows.stop + 1, h))
        bc = slice(max(cols.start - 1, 0), min(cols.stop + 1, w))
        for s in range(plan.slices):
            chans, convs = plan.slice_channels(s), []
            for d0 in range(chans.start, chans.stop, HIDDEN_CHUNK):
                d = slice(d0, min(d0 + HIDDEN_CHUNK, chans.stop))
                hid = gelu_exact(_mm_tf32(xf[:, br, bc], w1p[d].T, passes) + b1[d])
                canvas = torch.zeros(p, h + 2, w + 2, hid.shape[-1])  # zero border off the map
                canvas[:, br.start + 1:br.stop + 1, bc.start + 1:bc.stop + 1] = hid
                conv = torch.zeros(p, len(rows), len(cols), hid.shape[-1])
                for dy in range(3):
                    for dx in range(3):
                        win = canvas[:, rows.start + dy:rows.stop + dy,
                                     cols.start + dx:cols.stop + dx]
                        conv = conv + win * dw[d, dy, dx]
                convs.append(gelu_exact(conv + bdw[d]))
            part[s, :, rows.start:rows.stop, cols.start:cols.stop] = _mm_tf32(
                torch.cat(convs, -1), w2p[:, chans.start:chans.stop].T, passes)
    total = part[0]
    for s in range(1, plan.slices):
        total = total + part[s]
    return gelu_exact(total[..., :c] + b2).to(x.dtype)


def _inputs(p, h, w, c, seed):
    """x [P, H, W, C] and folded MlpDWBN weights in numpy (w1 [D, C], b1, dw
    [D, 3, 3], bdw, w2 [C, D], b2), D = 4C."""
    rng = np.random.RandomState(seed)
    d = 4 * c
    arrays = [2 * rng.rand(p, h, w, c) - 1, rng.randn(d, c) / np.sqrt(c), 0.1 * rng.randn(d),
              rng.randn(d, 3, 3) / 3, 0.1 * rng.randn(d), rng.randn(c, d) / np.sqrt(d),
              0.1 * rng.randn(c)]
    return [a.astype(np.float32) for a in arrays]


@pytest.mark.parametrize("h,w,c", BRANCH_MAPS + [(7, 6, 24)])
def test_tile_walk_matches_plain_and_pallas(h, w, c):
    x, *mlp = _inputs(2, h, w, c, h * 100 + c)
    plan = mlp32_plan(2, h, w, c, 4 * c)
    pt = [torch.from_numpy(a) for a in mlp]
    got = tile_mlp32(torch.from_numpy(x), *pt, plan).numpy()
    assert np.isfinite(got).all() and got.dtype == np.float32
    plain = mlp_dwbn_torch(torch.from_numpy(x), *pt).numpy()
    bound = TOL * np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=bound)
    w1, b1, dw, bdw, w2, b2 = mlp
    ref = np.asarray(jax_mlp_dwbn(jnp.asarray(x), w1.T, b1, dw.transpose(1, 2, 0), bdw, w2.T, b2,
                                  interpret=True))
    np.testing.assert_allclose(got, ref, rtol=0, atol=bound)


@pytest.mark.parametrize("h,w,c", [(64, 48, 78), (7, 6, 24)])
def test_one_tf32_pass_misses_the_bound(h, w, c):
    """hi . hi alone, as one TF32 pass computes it, is off by more than ten
    times the bound that three passes keep."""
    x, *mlp = _inputs(2, h, w, c, h * 100 + c)
    plan = mlp32_plan(2, h, w, c, 4 * c)
    pt = [torch.from_numpy(a) for a in mlp]
    xt = torch.from_numpy(x)
    plain = mlp_dwbn_torch(xt, *pt)
    scale = plain.abs().max().item()
    one = (tile_mlp32(xt, *pt, plan, passes=1) - plain).abs().max().item() / scale
    three = (tile_mlp32(xt, *pt, plan) - plain).abs().max().item() / scale
    assert one > 10 * TOL and three < TOL / 5, (one, three)


def test_walk_slices_and_ragged_tiles_in_bf16():
    """One slice and several, ragged tiles, bf16 x (phases 12-14 feed G
    bf16 too): the result is the plain version's once cast."""
    x, *mlp = _inputs(3, 9, 5, 24, 7)
    pt = [torch.from_numpy(a) for a in mlp]
    xt = torch.from_numpy(x).bfloat16()
    plain = mlp_dwbn_torch(xt, *pt).float()
    for sms in (1, 132):
        plan = mlp32_plan(3, 9, 5, 24, 96, sms)
        assert (plan.slices > 1) == (sms > 1) and plan.tiles > 1
        got = tile_mlp32(xt, *pt, plan)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), plain.numpy(), rtol=0,
                                   atol=2.0 ** -8 * plain.abs().max().item())



@pytest.mark.parametrize("value,want", [
    (1.0, 1.0), (0.0, 0.0), (-0.0, -0.0), (1 + 2.0 ** -11, 1 + 2.0 ** -10),  # a tie: away from 0
    (-(1 + 2.0 ** -11), -(1 + 2.0 ** -10)), (1 + 3 * 2.0 ** -11, 1 + 2.0 ** -9),  # tie, odd ulp
    (1 + 2.0 ** -11 - 2.0 ** -23, 1.0), (-(1 + 2.0 ** -11 - 2.0 ** -23), -1.0),  # below the tie
    (1 + 2.0 ** -10 + 2.0 ** -12, 1 + 2.0 ** -10), (2 - 2.0 ** -23, 2.0),  # carry into the exponent
    (2.0 ** -136 + 2.0 ** -137, 2.0 ** -135), (3.0 * 2.0 ** -140, 0.0),  # subnormal steps
    (np.inf, np.inf), (-np.inf, -np.inf),
    (float(np.finfo(np.float32).max), np.inf),
])
def test_tf32_rna_hand_values(value, want):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    assert got.item() == want and np.signbit(got.item()) == np.signbit(want)
    assert got.view(torch.int32).item() & 0x1FFF == 0


def test_tf32_rna_nan_and_the_dropped_bits():
    """NaN stays NaN; every normal f32 in a sweep rounds to the nearer of
    its two TF32 neighbours (13 low bits dropped), ties away from zero."""
    assert torch.isnan(tf32_rna(torch.tensor([float("nan")]))).all()
    rng = np.random.RandomState(3)
    bits = rng.randint(-2 ** 31, 2 ** 31 - 1, 20000, dtype=np.int64).astype(np.int32)
    x = bits.view(np.float32)
    x = x[np.isfinite(x) & (np.abs(x) < 1e38) & (np.abs(x) >= np.finfo(np.float32).tiny)]
    got = tf32_rna(torch.from_numpy(x)).numpy().astype(np.float64)
    down = (x.view(np.int32) & ~np.int32(0x1FFF)).view(np.float32).astype(np.float64)
    up = down + np.sign(x) * np.ldexp(1.0, np.frexp(np.abs(down))[1] - 11)
    xd = x.astype(np.float64)
    want = np.where(np.abs(xd - down) < np.abs(up - xd), down, up)
    np.testing.assert_array_equal(got, want)


def test_fragments_follow_the_m16n8k8_tf32_layout():
    """Lane l of n-tile j, k-step kk holds (hi, hi, lo, lo) of m[8j + l // 4,
    8kk + l % 4 + (0, 4)] (``mma.sync.m16n8k8`` TF32 B registers b0, b1 of
    the hi and the lo pass), zero past m; hi + lo gives m back within 2^-22."""
    rng = np.random.RandomState(5)
    n, k = 20, 30
    m = torch.from_numpy((rng.randn(n, k) * np.exp(rng.randn(n, k))).astype(np.float32))
    frag = pack_tf32x3(m, 24, 32)
    assert frag.shape == (3, 4, 32, 4) and frag.is_contiguous() and frag.dtype == torch.float32
    hi, lo = tf32_rna(m), tf32_rna(m - tf32_rna(m))
    for j in range(3):
        for kk in range(4):
            for lane in range(32):
                row = 8 * j + lane // 4
                for e, (src, off) in enumerate(((hi, 0), (hi, 4), (lo, 0), (lo, 4))):
                    col = 8 * kk + lane % 4 + off
                    want = src[row, col] if row < n and col < k else 0.0
                    assert frag[j, kk, lane, e] == want
    assert (frag.view(torch.int32) & 0x1FFF == 0).all()  # TF32 values
    back = (frag[..., 0] + frag[..., 2]).double()
    exact = torch.zeros(24, 32, dtype=torch.float64)
    exact[:n, :k] = m.double()
    exact = exact.reshape(3, 8, 4, 2, 4).permute(0, 2, 1, 4, 3)[..., 0].reshape(3, 4, 32)
    assert ((back - exact).abs() <= 2.0 ** -22 * exact.abs()).all()


def test_packed_weights_for_g():
    """W1 [D, C] and W2 [C, D] as TF32 fragments, D padded to 64 channels
    and C to 8; taps [3, 3, D] and biases f32, in ``pack_mlp``'s order."""
    _, w1, b1, dw, bdw, w2, b2 = (torch.from_numpy(a) for a in _inputs(1, 1, 1, 20, 2))
    w1p, b1f, dwt, bdwf, w2p, b2f = pack_mlp32(w1, b1, dw, bdw, w2, b2, "cpu")
    assert w1p.shape == (128 // 8, 24 // 8, 32, 4) and w2p.shape == (24 // 8, 128 // 8, 32, 4)
    assert torch.equal(w1p, pack_tf32x3(w1, 128, 24)) and torch.equal(w2p, pack_tf32x3(w2, 24, 128))
    assert torch.equal(dwt, dw.permute(1, 2, 0)) and torch.equal(b1f, b1)
    assert torch.equal(bdwf, bdw) and torch.equal(b2f, b2)


#: 256x192's and 384x288's maps at P=32 and P=8, small and ragged maps, a
#: 16x12 map at C=624 (branch 3 of a 512x384 input)
PLAN_MAPS = [(32, h, w, c) for h, w, c in BRANCH_MAPS] + [
    (8, 96, 72, 78), (8, 48, 36, 156), (8, 24, 18, 312), (8, 12, 9, 624), (3, 7, 6, 24),
    (2, 9, 5, 24), (1, 10, 17, 16), (4, 1, 1, 8), (2, 16, 12, 624)]


@pytest.mark.parametrize("shape", PLAN_MAPS)
def test_plan_covers_every_pixel_and_channel_once(shape):
    p, h, w, c = shape
    d = 4 * c
    plan = mlp32_plan(p, h, w, c, d)
    seen = np.zeros((h, w), np.int64)
    for tile in range(plan.tiles):
        rows, cols = plan.tile_pixels(tile)
        assert len(rows) and len(cols)
        seen[rows.start:rows.stop, cols.start:cols.stop] += 1
    assert (seen == 1).all()
    chans = np.zeros(d, np.int64)
    for s in range(plan.slices):
        sl = plan.slice_channels(s)
        assert len(sl) and sl.start % HIDDEN_CHUNK == 0
        chans[sl.start:sl.stop] += 1
    assert (chans == 1).all()
    assert plan.grid == (plan.tiles, plan.slices, p) and plan.smem <= MAX_SMEM
    assert plan.th <= TILE and plan.tw <= TILE
    box = pad16(min(plan.th + 2, h) * min(plan.tw + 2, w))
    assert pad16(plan.th * plan.tw) <= 64 and box <= 112
    per = -(-(-(-d // HIDDEN_CHUNK)) // plan.slices)
    assert plan.smem == 4 * (box * (pad8(c) + PAD32) + box * (HIDDEN_CHUNK + PAD32)
                             + pad16(plan.th * plan.tw) * (per * HIDDEN_CHUNK + PAD32))


def test_plan_on_hrt_maps():
    """At 256x192's four branch maps (P=32): two blocks per SM with 8x8
    tiles and three slices on branch 0, 4x8 tiles (evened out: 4x6 on
    16x12) on branches 1 and 2, where 8x8 tiles fit one block per SM only;
    one block per SM of 8x6 tiles on branch 3, whose 624 channels of x fill
    half an SM alone; every grid holds at least 256 blocks (about 2 per SM
    of 132)."""
    want = {78: ((8, 8), 3, True), 156: ((4, 8), 2, True), 312: ((4, 6), 4, True),
            624: ((8, 6), 8, False)}
    for h, w, c in BRANCH_MAPS:
        plan = mlp32_plan(32, h, w, c, 4 * c, 132)
        tile, slices, two = want[c]
        assert ((plan.th, plan.tw), plan.slices) == (tile, slices)
        assert (plan.smem <= TWO_PER_SM) == two and plan.blocks >= 256
    assert mlp32_plan(32, 32, 24, 156, 624).partial_bytes <= PARTIAL_LIMIT


def test_plan_takes_small_tiles_and_refuses_what_does_not_fit():
    """Where no 8x8 block fits one SM's shared memory (C = 624 on a 16x12
    map: 223 KB of x and hidden chunk alone) the plan takes 4x4 tiles; a
    width whose f32 tile + halo outgrows one block even then has no plan."""
    plan = mlp32_plan(2, 16, 12, 624, 2496)
    assert (plan.th, plan.tw) == (4, 4) and plan.smem <= MAX_SMEM
    assert _mma32_smem(624, 16, 12, 8, 6, 2496, 39) > MAX_SMEM
    with pytest.raises(ValueError, match="does not fit"):
        mlp32_plan(2, 8, 8, 1200, 4800)


def _cuh_constants():
    """{name: value} of the ``constexpr`` integers of ``csrc/common.cuh`` and
    ``csrc/mlp_dwbn.cuh``, in the order they are declared."""
    src = "".join((build.CSRC / n).read_text() for n in ("common.cuh", "mlp_dwbn.cuh"))
    found = {}
    for name, expr in re.findall(r"constexpr (?:int|size_t) (k\w+) = ([^;]+);", src):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))  # integer arithmetic only
    return found


def test_plan_limits_are_the_kernel_sources():
    """The plan's constants are those G's body compiles (``mlp32_plan``
    picks, ``mlp32_fits`` refuses at launch): the chunk, the f32 rows'
    padding (a stride of 4 mod 8 words), the two shared-memory limits, an
    8x8 tile with its halo within the body's row tiles."""
    k = _cuh_constants()
    assert HIDDEN_CHUNK == k["kHC"] and PAD32 == k["kPad32"] and k["kHLd32"] == k["kHC"] + PAD32
    assert PAD32 % 8 == 4 and HIDDEN_CHUNK % 8 == 0
    assert TWO_PER_SM == k["kTwoPerSm"] and MAX_SMEM == k["kMaxSmem"]
    assert TILE <= k["kMaxTw"] and pad16(TILE * TILE) <= 16 * k["kOutTiles"]
    assert pad16((TILE + 2) ** 2) <= 16 * k["kBoxTiles"]
    assert HIDDEN_CHUNK == 8 * k["kWarps"]  # the expand: one 8-channel n-tile a warp


def test_c_entry_point_takes_the_plan():
    """``i2r_mlp_dwbn_fwd`` takes the plan (tile, slices) and the slices'
    scratch, as ``i2r_mlp_block_fwd`` does, and ctypes passes each."""
    src = (build.CSRC / "mlp_dwbn.cu").read_text()
    m = re.search(r'extern "C" int i2r_mlp_dwbn_fwd\((.*?)\)\s*\{', src, re.S)
    names = [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]
    assert names == ["x", "w1", "b1", "dwt", "bdw", "w2", "b2", "out", "part", "p", "h", "w", "c",
                     "dh", "th", "tw", "slices", "dtype", "stream"]
    sig = build.SIGNATURES["i2r_mlp_dwbn_fwd"]
    assert len(sig) == len(names) and sig[8] is sig[0] and sig[14:17] == (sig[9],) * 3


def test_block_caches_g_fragments():
    """An HRFormer block on the G route packs its BN-folded weights once as
    ``pack_mlp32`` does, whatever x's dtype."""
    from i2rnet_tpu_torch.models.hrformer import HRFormerBlock

    blk = HRFormerBlock(24, 3, 7, 4.0).eval()
    x = torch.zeros(1, 7, 6, 24, dtype=torch.bfloat16)
    got = blk._kernel_weights("mlp32", x)
    want = pack_mlp32(*blk.mlp.folded_params(), "cpu")
    assert len(got) == 6 and all(torch.equal(a, b) for a, b in zip(got, want))
    assert blk._kernel_weights("mlp32", x) is got
