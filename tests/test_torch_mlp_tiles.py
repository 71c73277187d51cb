"""The algorithm of Kernel F's bf16 tensor-core body, and its launch plan, on the CPU.

``csrc/mlp_dwbn.cuh::mlp_item_mma`` (Kernel F in bf16, and phase 2 of
kernel 7) walks each person's map in output tiles, each with its 1-pixel
halo cut to the map, and the D hidden channels in slices of 64-channel
chunks: per chunk the expand of the box (LN2 rounded, channels zero-padded
to 16), GELU and rounding, the depthwise 3x3 with a zero border off the map,
GELU and rounding, and the chunk's share of the contract in f32; the slices'
f32 sums are added in the order s = 0 ... S-1 before + b2, GELU, rounding
and the residual. The CUDA kernel runs only on the card; :func:`tile_mlp`
is that walk in a few lines of torch, held against the port's plain version
(``mlp_block_torch``) and the JAX Pallas kernel (interpret mode) on the same
numpy inputs, with the tiles and slices of ``ops/cuda/mlp_dwbn.py::mlp_plan``.

Tolerances: in bfloat16 the walk and the references round at the same
points, so a value differs only where two f32 summation orders straddle a
rounding boundary of an intermediate; such a flip moves one hidden value by
one bf16 step and reaches the output through a contraction with weights of
norm about 1, far below one step of the output. The checks allow 2^-8 of
max|ref| (one step of the output is at most 2^-7 of its value). In float32
nothing rounds but the order of the sums: 1e-5 of max|ref|.
"""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from i2rnet_tpu.ops.pallas.hrformer_block import mlp_block_fused as jax_mlp_block
from i2rnet_tpu.ops.pallas.mlp_dwbn import fold_bn as jax_fold_bn
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.hrformer_block import layer_norm_f32, mlp_block_torch
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import (HIDDEN_CHUNK, MAX_SMEM, PARTIAL_LIMIT, TILE,
                                                TWO_PER_SM, fold_bn, gelu_tanh_erf, mlp_plan,
                                                pack_fragments, pack_mlp, pad16)
from i2rnet_tpu_torch.probes import mlp_sweep

torch.set_num_threads(2)

TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}  # of max|ref|
#: HRFormer-B's four branch maps of a 256x192 input at P=32 persons (P, H, W, C)
HRT_MAPS = [(32, 64, 48, 78), (32, 32, 24, 156), (32, 16, 12, 312), (32, 8, 6, 624)]


def tile_mlp(x, ln_w, ln_b, w1, b1, dw, bdw, w2, b2, plan, eps=1e-6):
    """``x + MlpDWBN(LN2(x))`` ``[P, H, W, C]`` as the bf16 body walks it under
    ``plan``, with x's dtype as the rounding type (float32: no rounding)."""
    dt = x.dtype
    r = lambda a: a.to(dt).float()  # noqa: E731  the value once stored in dt
    p, h, w, c = x.shape
    w1r, w2r = r(w1), r(w2)
    part = torch.zeros(plan.slices, p, h, w, c)
    for person in range(p):
        for tile in range(plan.tiles):
            rows, cols = plan.tile_pixels(tile)
            br = slice(max(rows.start - 1, 0), min(rows.stop + 1, h))
            bc = slice(max(cols.start - 1, 0), min(cols.stop + 1, w))
            y = r(layer_norm_f32(x[person, br, bc], ln_w, ln_b, eps))
            y = F.pad(y, (0, pad16(c) - c))  # zero channels: zero products
            for s in range(plan.slices):
                acc = torch.zeros(len(rows), len(cols), c)
                chans = plan.slice_channels(s)
                for d0 in range(chans.start, chans.stop, HIDDEN_CHUNK):
                    d = slice(d0, min(d0 + HIDDEN_CHUNK, chans.stop))
                    w1c = F.pad(w1r[d], (0, pad16(c) - c))
                    hid = r(gelu_tanh_erf(y @ w1c.T + b1[d]))
                    canvas = torch.zeros(h + 2, w + 2, hid.shape[-1])  # zero border off the map
                    canvas[br.start + 1:br.stop + 1, bc.start + 1:bc.stop + 1] = hid
                    conv = torch.zeros(len(rows), len(cols), hid.shape[-1])
                    for dy in range(3):
                        for dx in range(3):
                            win = canvas[rows.start + dy:rows.stop + dy,
                                         cols.start + dx:cols.stop + dx]
                            conv = conv + win * dw[d, dy, dx]
                    acc = acc + r(gelu_tanh_erf(conv + bdw[d])) @ w2r[:, d].T
                part[s, person, rows.start:rows.stop, cols.start:cols.stop] = acc
    total = part[0]
    for s in range(1, plan.slices):
        total = total + part[s]
    return (x.float() + r(gelu_tanh_erf(total + b2))).to(dt)


def _params(rng, c, d):
    """LN2 and BN-folded MlpDWBN weights: (jax [ln.., w1 [C,D], b1, dw [3,3,D],
    bdw, w2 [D,C], b2], torch [ln.., w1 [D,C], b1, dw [D,3,3], bdw, w2 [C,D], b2])."""
    ln = [rng.uniform(0.5, 1.5, c).astype(np.float32), (0.1 * rng.randn(c)).astype(np.float32)]
    conv = [(rng.randn(c, d) / np.sqrt(c)), 0.1 * rng.randn(d), rng.randn(3, 3, d) / 3,
            0.1 * rng.randn(d), rng.randn(d, c) / np.sqrt(d), 0.1 * rng.randn(c)]
    conv = [a.astype(np.float32) for a in conv]
    bns = [tuple(a.astype(np.float32) for a in (rng.uniform(0.5, 1.5, n), 0.1 * rng.randn(n),
                                                0.1 * rng.randn(n), rng.uniform(0.5, 1.5, n)))
           for n in (d, d, c)]
    jx, pt = list(ln), [torch.from_numpy(a) for a in ln]
    for (wt, bias), bn in zip(zip(conv[::2], conv[1::2]), bns):
        k, sh = (np.asarray(a) for a in jax_fold_bn(*bn))
        jx += [wt * k, bias * k + sh]
        kt, sht = fold_bn(*map(torch.from_numpy, bn))
        t = torch.from_numpy(wt)
        t = t.permute(2, 0, 1) if t.dim() == 3 else t.T
        pt += [t * kt.reshape(-1, *[1] * (t.dim() - 1)), torch.from_numpy(bias) * kt + sht]
    return jx, pt


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms", [1, 132])  # one slice; as many slices as the small grid takes
@pytest.mark.parametrize("c", [24, 78])
@pytest.mark.parametrize("h,w", [(9, 5), (7, 6)])
def test_tile_walk_matches_plain_and_pallas(h, w, c, sms, dtype):
    rng = np.random.RandomState(h * 100 + c)
    p, d = 2, 4 * c
    x = (rng.rand(p, h, w, c) * 2 - 1).astype(np.float32)
    jx, pt = _params(rng, c, d)
    plan = mlp_plan(p, h, w, c, d, sms)
    assert (plan.slices > 1) == (sms > 1)
    assert d % HIDDEN_CHUNK or plan.slices > 1  # a ragged last chunk, or several slices
    xt = torch.from_numpy(x).to(dtype)
    got = tile_mlp(xt, *pt, plan).float().numpy()
    assert np.isfinite(got).all()
    plain = mlp_block_torch(xt, *pt).float().numpy()
    bound = TOL[dtype] * np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=bound)
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    ref = np.asarray(jax_mlp_block(xj, *jx, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=bound)


#: 384x288's four maps at P=8, small and ragged maps, and a 16x12 map at C=624
#: (branch 3 of a 512x384 input), where two blocks per SM do not fit
PLAN_MAPS = HRT_MAPS + [(8, 96, 72, 78), (8, 48, 36, 156), (8, 24, 18, 312), (8, 12, 9, 624),
                        (3, 7, 6, 24), (2, 9, 5, 24), (1, 10, 17, 16), (4, 1, 1, 8),
                        (2, 16, 12, 624)]


@pytest.mark.parametrize("shape", PLAN_MAPS)
def test_plan_covers_every_pixel_and_channel_once(shape):
    p, h, w, c = shape
    d = 4 * c
    plan = mlp_plan(p, h, w, c, d)
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
    assert plan.grid == (plan.tiles, plan.slices, p)
    assert plan.th <= TILE and plan.tw <= TILE and plan.smem <= MAX_SMEM
    assert plan.partial_bytes <= PARTIAL_LIMIT


def test_plan_fills_the_card_on_hrt_maps():
    """At each of 256x192's four branch maps at P=32 the bf16 grid holds at
    least 256 blocks (about 2 per SM of 132) with at most 32 MiB of slice
    sums; the output tile and tile + halo fit the body, two blocks an SM
    fit its shared memory, and the 8x6 map is one tile."""
    want = {78: ((8, 8), 1), 156: ((8, 8), 2), 312: ((8, 6), 3), 624: ((8, 6), 8)}
    for p, h, w, c in HRT_MAPS:
        plan = mlp_plan(p, h, w, c, 4 * c, 132)
        assert ((plan.th, plan.tw), plan.slices) == want[c]
        assert plan.blocks >= 256 and plan.partial_bytes <= PARTIAL_LIMIT == 32 << 20
        assert pad16(plan.th * plan.tw) <= 64 and plan.smem <= TWO_PER_SM
        assert pad16(min(plan.th + 2, h) * min(plan.tw + 2, w)) <= 112


def test_plan_takes_wide_maps_and_refuses_what_does_not_fit():
    """Width never changes the tile: where no number of slices keeps two
    blocks per SM in shared memory (C = 624 on a 16x12 map, C = 700 on
    16x16) the plan takes one; a width whose LN'd tile + halo alone outgrows
    one block's shared memory has no plan."""
    for p, h, w, c, tile in ((2, 16, 12, 624, (8, 6)), (2, 16, 16, 700, (8, 8))):
        plan = mlp_plan(p, h, w, c, 4 * c)
        assert (plan.th, plan.tw) == tile and TWO_PER_SM < plan.smem <= MAX_SMEM
    assert mlp_plan(2, 8, 8, 700, 2800).smem <= TWO_PER_SM  # a whole-map tile: a smaller halo
    with pytest.raises(ValueError, match="does not fit"):
        mlp_plan(2, 8, 8, 8000, 32000)


def _cuh_constants():
    """{name: value} of the ``constexpr`` integers of ``csrc/common.cuh`` and
    ``csrc/mlp_dwbn.cuh``, in the order they are declared."""
    src = "".join((build.CSRC / n).read_text() for n in ("common.cuh", "mlp_dwbn.cuh"))
    found = {}
    for name, expr in re.findall(r"constexpr (?:int|size_t) (k\w+) = ([^;]+);", src):
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))  # integer arithmetic only
    return found


def test_plan_limits_are_the_kernel_sources():
    """The plan's constants are those the kernels compile (``mlp_plan``
    picks, ``mlp_mma_fits`` refuses at launch): the chunk, the two shared
    memory limits, and an 8x8 tile with its halo within the body's row tiles."""
    k = _cuh_constants()
    assert HIDDEN_CHUNK == k["kHC"] and TWO_PER_SM == k["kTwoPerSm"]
    assert MAX_SMEM == k["kMaxSmem"]
    assert TILE <= k["kMaxTw"] and pad16(TILE * TILE) <= 16 * k["kOutTiles"]
    assert pad16((TILE + 2) ** 2) <= 16 * k["kBoxTiles"]


@pytest.mark.parametrize("variant", sorted(mlp_sweep.VARIANTS))
def test_sweep_variants_find_their_text(variant):
    """Each variant of ``probes/mlp_sweep.py`` edits text that
    ``csrc/mlp_dwbn.cuh`` holds, once."""
    src = (build.CSRC / "mlp_dwbn.cuh").read_text()
    for old, new in mlp_sweep.VARIANTS[variant]:
        assert src.count(old) == 1 and old != new


def test_fragments_follow_the_mma_operand_layout():
    """Lane l of n-tile j, k-step kk holds m[8j + l // 4, 16kk + 2(l % 4) +
    (0, 1, 8, 9)] (``mma.sync.m16n8k16`` B registers b0, b1), zero past m."""
    rng = np.random.RandomState(5)
    n, k = 20, 40
    m = torch.from_numpy(rng.randn(n, k).astype(np.float32)).bfloat16()
    frag = pack_fragments(m, 24, 48)
    assert frag.shape == (3, 3, 32, 4) and frag.is_contiguous()
    for j in range(3):
        for kk in range(3):
            for lane in range(32):
                row = 8 * j + lane // 4
                for e, off in enumerate((0, 1, 8, 9)):
                    col = 16 * kk + 2 * (lane % 4) + off
                    want = m[row, col] if row < n and col < k else 0.0
                    assert frag[j, kk, lane, e] == want


def test_packed_weights_by_dtype():
    """bf16: W1 [D, C] and W2 [C, D] as fragments, D padded to 64 channels and
    C to 16; f32: the CUDA-core template's transposes. Taps and biases f32."""
    rng = np.random.RandomState(1)
    _, (g, b, w1, b1, dw, bdw, w2, b2) = _params(rng, 24, 96)
    w1p, b1f, dwt, bdwf, w2p, b2f = pack_mlp(w1, b1, dw, bdw, w2, b2, torch.bfloat16, "cpu")
    assert w1p.shape == (128 // 8, 32 // 16, 32, 4) and w2p.shape == (32 // 8, 128 // 16, 32, 4)
    assert torch.equal(w1p, pack_fragments(w1.bfloat16(), 128, 32))
    assert torch.equal(w2p, pack_fragments(w2.bfloat16(), 32, 128))
    assert b1f.shape == (96,) and dwt.shape == (3, 3, 96) and dwt.dtype == torch.float32
    w1t, *_, w2t, _ = pack_mlp(w1, b1, dw, bdw, w2, b2, torch.float32, "cpu")
    assert torch.equal(w1t, w1.T) and torch.equal(w2t, w2.T)


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float, "unsigned": ctypes.c_uint}


@pytest.mark.parametrize("entry", sorted(build.SIGNATURES))
def test_signatures_match_the_c_entry_points(entry):
    """Each ctypes signature has the C entry point's arity and types
    (pointers and the stream as void*), read from ``csrc/*.cu``."""
    src = "".join(p.read_text() for p in build.sources())
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src, re.S)
    assert m, entry
    want = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        want.append(ctypes.c_void_p if "*" in param else _CTYPE[param.split()[0]])
    assert list(build.SIGNATURES[entry]) == want
