"""The algorithm of the FFN tail's bf16 tensor-core body, and its launch plan, on the CPU.

``csrc/ffn_tile.cuh`` (Kernel B, Kernel D's forward and its backward's pass
1; passes 2 and 3 in ``csrc/encoder_ffn_train.cu``) walk the token rows in units of 16 (a warp's
rows; unit u to block u % grid), C zero-padded to 16 and F to 64 in chunks of
64 hidden columns: per chunk h = T(n) . T(W1_c)^T + b1, ReLU, drop1 and the
rounding, then y += T(a_c) . T(W2_c)^T in f32; then the residual on the f32
n, drop2 and LN2. The backward recomputes that walk, rounds dy and da before
their products (da_c = T(dy) . T(W2_c), dn = dz + sum_c T(da_c) . T(W1_c)),
and sums the weight gradients over row slices (pass 2) and the vector
gradients over the blocks (pass 1's partials), each in a fixed order. The
CUDA kernels run only on the card; :func:`tile_forward` and
:func:`tile_backward` are their walk in a few lines of torch, held against
the port's plain versions, autograd of them, and the JAX Pallas kernels
(interpret mode, bits mode for the dropout) on the same numpy inputs, with
the units, chunks and slices of ``ops/cuda/encoder_ffn.py::ffn_plan``.

Tolerances: in float32 nothing rounds but the order of the sums: 1e-5 of
max|ref|. In bfloat16 the walk and the references round at the same points,
so an element differs only where two f32 summation orders put a rounded
value on either side of a bf16 boundary: an output element by one bf16 step
of itself (2^-7 |ref|, the outputs are rounded) where its own rounding
flips, and far less where an intermediate's does; the checks allow 2^-7
|ref| + 2^-9 max|ref|. The weight gradients in bfloat16 sum rounded operands
in f32, as the Pallas kernel does; a flipped operand moves a sum over the
rows by far less than 2^-8 max|ref|, which the checks allow.
"""

import ctypes
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from i2rnet_tpu.ops.pallas.encoder_ffn import encoder_ffn_fused as jax_ffn
from i2rnet_tpu.ops.pallas.encoder_ffn_train import encoder_ffn_train as jax_ffn_train
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.dropout import keep_mask
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import (CHUNK, MAX_CP, MAX_SMEM, TILE_ROWS,
                                                   TILE_WARPS, TWO_PER_SM, UNIT, W_TILE,
                                                   encoder_ffn_torch, ffn_plan, ffn_smem)
from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import encoder_ffn_train_torch
from i2rnet_tpu_torch.probes import ffn_sweep

torch.set_num_threads(2)

EPS = 1e-5
RATE = 0.1
#: (C, F): W48's encoder, HRT's, and a small one (F a single, partial chunk);
#: then the widened instances' cat_vec widths, TPH's C = 96 + 96 and HRT's
#: 78 + 96 (padded to 176)
WIDTHS = [(96, 192), (78, 192), (16, 32), (192, 192), (174, 192)]
#: R ragged (the last unit part real) and a whole number of 64-row tiles
ROWS = [1003, 256]


def _r(a, dt):
    """The value of ``a`` once stored in ``dt``, as f32."""
    return a.to(dt).float()


def _ln(v, g, b):
    """(normalised v, the LayerNorm's value, rstd)."""
    mean = v.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((v - mean) ** 2).mean(-1, keepdim=True) + EPS)
    z = (v - mean) * rstd
    return z, z * g + b, rstd


def _padded(p, plan, dt):
    """W1 [FP, CP], W2 [CP, FP] rounded to ``dt``, b1 [FP], zero past C and F."""
    _, _, w1, b1, w2, _, _, _ = p
    c, f = w1.shape[1], w1.shape[0]
    return (F.pad(_r(w1, dt), (0, plan.cp - c, 0, plan.fp - f)),
            F.pad(_r(w2, dt), (0, plan.fp - f, 0, plan.cp - c)), F.pad(b1, (0, plan.fp - f)))


def tile_forward(x, p, plan, keep=None):
    """``out`` [R, C] in x's dtype as the body walks it, and what the backward
    keeps: (z1, rstd1, T(n), the T(a) chunks, their gates, z2, rstd2).
    ``keep``: drop1's and drop2's keep masks ([R, F], [R, C]) or None."""
    dt, (rows, c) = x.dtype, x.shape
    g1, be1, _, _, _, b2, g2, be2 = p
    w1p, w2p, b1p = _padded(p, plan, dt)
    z1, n, rstd1 = _ln(x.float(), g1, be1)
    na = F.pad(_r(n, dt), (0, plan.cp - c))
    y = torch.zeros(rows, plan.cp)
    chunks, gates = [], []
    for ch in range(plan.fp // CHUNK):
        s = slice(ch * CHUNK, (ch + 1) * CHUNK)
        h = na @ w1p[s].T + b1p[s]
        on, a = h > 0, torch.relu(h)
        if keep is not None:
            k = F.pad(keep[0], (0, plan.fp - keep[0].shape[1]))[:, s]
            on, a = on & k, torch.where(k, a / (1 - RATE), 0.0)
        a = _r(a, dt)
        chunks.append(a)
        gates.append(on)
        y = y + a @ w2p[:, s].T
    v = y[:, :c] + b2
    if keep is not None:
        v = torch.where(keep[1], v / (1 - RATE), 0.0)
    z2, out, rstd2 = _ln(n + v, g2, be2)
    return out.to(dt), (z1, rstd1, na, chunks, gates, z2, rstd2)


def _in_order(parts):
    """sum of ``parts`` [k, ...] over k in the order k = 0, 1, ..."""
    total = parts[0].clone()
    for part in parts[1:]:
        total = total + part
    return total


def tile_backward(x, gout, p, plan, keep=None):
    """(dx, dln1_w, dln1_b, dw1, db1, dw2, db2, dln2_w, dln2_b) as the three
    launches compute them: pass 1 per row (the vector gradients summed per
    block of the plan's grid, then over the blocks in order), pass 2's slices
    of ``plan.slice_rows`` rows, each slice's sum added in order."""
    dt, (rows, c) = x.dtype, x.shape
    f = p[2].shape[0]
    g1, _, _, _, _, _, g2, _ = p
    w1p, w2p, _ = _padded(p, plan, dt)
    _, (z1, rstd1, na, chunks, gates, z2, rstd2) = tile_forward(x, p, plan, keep)
    g = gout.float()
    dzh = g * g2
    dz = (dzh - dzh.sum(-1, keepdim=True) / c - z2 * (dzh * z2).sum(-1, keepdim=True) / c) * rstd2
    dy = dz if keep is None else torch.where(keep[1], dz / (1 - RATE), 0.0)
    dyb = F.pad(_r(dy, dt), (0, plan.cp - c))
    dn = F.pad(dz, (0, plan.cp - c))
    das = []
    for ch, on in enumerate(gates):
        s = slice(ch * CHUNK, (ch + 1) * CHUNK)
        da = dyb @ w2p[:, s]
        da = torch.where(on, da if keep is None else da / (1 - RATE), 0.0)
        das.append(da)
        dn = dn + _r(da, dt) @ w1p[s]
    dn = dn[:, :c]
    d = dn * g1
    dx = (d - d.sum(-1, keepdim=True) / c - z1 * (d * z1).sum(-1, keepdim=True) / c) * rstd1
    da = torch.cat(das, 1)

    block = (torch.arange(rows) // UNIT) % plan.bwd_grid

    def by_blocks(v):  # pass 1's block partials, then their sum in order
        return _in_order(torch.zeros(plan.bwd_grid, v.shape[1]).index_add_(0, block, v))

    ab, dab = torch.cat(chunks, 1), _r(da, dt)

    def by_slices(a, b):  # pass 2: sum_r a[r]^T b[r] per slice, then in order
        return _in_order(torch.stack([a[s:s + plan.slice_rows].T @ b[s:s + plan.slice_rows]
                                      for s in range(0, rows, plan.slice_rows)]))

    return (dx.to(dt), by_blocks(dn * z1), by_blocks(dn), by_slices(dab, na)[:f, :c],
            by_blocks(da)[:f], by_slices(dyb, ab)[:c, :f], by_blocks(dy), by_blocks(g * z2),
            by_blocks(g))


def _params(rng, c, f):
    """(torch [LN1, W1 [F, C], b1, W2 [C, F], b2, LN2], jax: W1 [C, F], W2 [F, C])."""
    ln = lambda: [rng.uniform(0.5, 1.5, c), 0.1 * rng.randn(c)]  # noqa: E731
    p = ln() + [rng.randn(f, c) / np.sqrt(c), 0.1 * rng.randn(f), rng.randn(c, f) / np.sqrt(f),
                0.1 * rng.randn(c)] + ln()
    p = [a.astype(np.float32) for a in p]
    jx = p[:2] + [p[2].T, p[3], p[4].T] + p[5:]
    return [torch.from_numpy(a) for a in p], [jnp.asarray(a) for a in jx]


def _bits(rng, rows, c, f):
    """The JAX kernel's bits ([1024-row tiles, 128-lane F], [..., C]) and the
    port's keep masks [R, F], [R, C] from them."""
    rp = -(-rows // 1024) * 1024
    b1 = rng.randint(0, 2 ** 32, (rp, -(-f // 128) * 128), dtype=np.uint64).astype(np.uint32)
    b2 = rng.randint(0, 2 ** 32, (rp, -(-c // 128) * 128), dtype=np.uint64).astype(np.uint32)
    keep = tuple(keep_mask(torch.from_numpy(b[:rows, :w].astype(np.int64)), RATE)
                 for b, w in ((b1, f), (b2, c)))
    words = tuple(torch.from_numpy(b[:rows, :w].astype(np.int64)) for b, w in ((b1, f), (b2, c)))
    return (jnp.asarray(b1), jnp.asarray(b2)), keep, words


def _check(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert np.isfinite(got).all(), what
    scale = np.abs(ref).max()
    bound = (1e-5 * scale if dtype == torch.float32
             else 2.0 ** -7 * np.abs(ref) + 2.0 ** -9 * scale)
    np.testing.assert_array_less(np.abs(got - ref), bound + 1e-30, err_msg=what)


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("c,f", WIDTHS)
def test_forward_walk_matches_plain_and_pallas(c, f, rows, dtype):
    """Kernel B (no dropout) and Kernel D's forward (bits mode) against their
    plain versions and the JAX Pallas kernels."""
    rng = np.random.RandomState(c + rows)
    xn = (2 * rng.randn(rows, c) + 0.5).astype(np.float32)
    pt, pj = _params(rng, c, f)
    jbits, keep, words = _bits(rng, rows, c, f)
    plan = ffn_plan(rows, c, f, 132)
    x = torch.from_numpy(xn).to(dtype)
    xj = jnp.asarray(xn).astype(_jdt(dtype))

    got, _ = tile_forward(x, pt, plan)
    _check(got.float(), encoder_ffn_torch(x, *pt).float(), dtype, "B vs plain")
    _check(got.float(), jax_ffn(xj, *pj, interpret=True).astype(jnp.float32), dtype, "B vs Pallas")

    got, _ = tile_forward(x, pt, plan, keep)
    ref = encoder_ffn_train_torch(x, *pt, dropout_rate=RATE, dropout_bits=words)
    _check(got.float(), ref.float(), dtype, "D vs plain")
    ref = jax_ffn_train(xj, *pj, RATE, dropout_bits=jbits, interpret=True)
    _check(got.float(), ref.astype(jnp.float32), dtype, "D vs Pallas")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,f", WIDTHS)
def test_backward_walk_matches_autograd_and_pallas(c, f, dtype):
    """Kernel D's backward at R = 1003 (bits mode): dx against the Pallas
    kernel through ``jax.vjp``; the weight gradients (slices summed in
    order) and the vector gradients (blocks summed in order) against
    autograd of the plain version in float32, the Pallas kernel's in bfloat16
    (the plain version rounds its products' outputs where both kernels round
    their operands)."""
    rows = 1003
    rng = np.random.RandomState(7 * c)
    xn = (2 * rng.randn(rows, c) + 0.5).astype(np.float32)
    gn = rng.randn(rows, c).astype(np.float32)
    pt, pj = _params(rng, c, f)
    jbits, keep, words = _bits(rng, rows, c, f)
    plan = ffn_plan(rows, c, f, 4, backward=True)  # several blocks, slices and units a block
    assert plan.slices > 1 and plan.units > 4 * plan.bwd_grid
    x, gout = torch.from_numpy(xn).to(dtype), torch.from_numpy(gn).to(dtype)
    got = tile_backward(x, gout, pt, plan, keep)

    xj, gj = jnp.asarray(xn).astype(_jdt(dtype)), jnp.asarray(gn).astype(_jdt(dtype))
    _, vjp = jax.vjp(lambda *a: jax_ffn_train(*a, RATE, dropout_bits=jbits, interpret=True),
                     xj, *pj)
    jg = [np.asarray(a.astype(jnp.float32)) for a in vjp(gj)]
    jg = jg[:3] + [jg[3].T, jg[4], jg[5].T] + jg[6:]  # torch layouts
    _check(got[0].float(), jg[0], dtype, "dx vs Pallas")
    if dtype == torch.float32:
        xs = [x.clone().requires_grad_(True)] + [q.clone().requires_grad_(True) for q in pt]
        out = encoder_ffn_train_torch(*xs, dropout_rate=RATE, dropout_bits=words)
        ref = [a.numpy() for a in torch.autograd.grad(out, xs, gout)]
    else:
        ref = jg
    names = ("dln1_w", "dln1_b", "dw1", "db1", "dw2", "db2", "dln2_w", "dln2_b")
    for name, a, r in zip(names, got[1:], ref[1:]):
        a, r = a.numpy(), np.asarray(r)
        assert a.shape == r.shape, name
        bound = (1e-5 if dtype == torch.float32 else 2.0 ** -8) * np.abs(r).max()
        np.testing.assert_allclose(a, r, rtol=0, atol=bound, err_msg=name)


#: the main path's shapes: W48 eval (B=16) and train (B=8), HRT eval and train
MAIN = [(16 * 1344, 96), (8 * 1344, 96), (8 * 768, 78), (12 * 384, 78)]


@pytest.mark.parametrize("rows,c", MAIN + [(1003, 16), (64, 16), (1, 96)])
def test_plan_covers_every_row_once(rows, c):
    """Units of UNIT rows cover the rows once (unit u to block u % grid, its
    warps in turn); the slices of pass 2 are whole stages of W_TILE rows and
    cover the rows once."""
    plan = ffn_plan(rows, c, 192, 132, backward=True)
    assert plan.units == -(-rows // UNIT) and plan.units * UNIT - rows < UNIT
    for grid in (plan.grid, plan.bwd_grid):
        assert 1 <= grid <= min(plan.units, 2 * 132)
        owner = {}
        for u in range(plan.units):
            owner.setdefault((u % grid, (u // grid) % TILE_WARPS), []).append(u)
        assert sorted(v for us in owner.values() for v in us) == list(range(plan.units))
    assert plan.slice_rows % W_TILE == 0
    assert (plan.slices - 1) * plan.slice_rows < rows <= plan.slices * plan.slice_rows
    assert plan.part_numel == plan.slices * 2 * plan.fp * plan.cp64


@pytest.mark.parametrize("rows,c", MAIN)
def test_plan_fills_the_card_on_the_main_path(rows, c):
    """Two blocks per SM at every main-path shape (shared memory and grid),
    and pass 2 at least two blocks per SM."""
    plan = ffn_plan(rows, c, 192, 132, backward=True)
    assert max(plan.fwd_smem, plan.bwd_smem) <= TWO_PER_SM
    assert plan.grid == plan.bwd_grid == min(plan.units, 2 * 132)
    assert plan.slices * plan.dw_blocks >= 2 * 132


def test_plan_refuses_what_the_body_does_not_take():
    """C above MAX_CP, and weights whose shared memory exceeds MAX_SMEM (the
    forward's, or with ``backward`` pass 1's), raise: no quiet fall-back."""
    with pytest.raises(ValueError, match=f"C up to {MAX_CP}"):
        ffn_plan(100, MAX_CP + 1, 64)
    with pytest.raises(ValueError, match="shared memory"):
        ffn_plan(100, 128, 4096)
    f = next(f for f in range(64, 4096, 64)
             if ffn_smem(128, f, False) <= MAX_SMEM < ffn_smem(128, f, True))
    assert ffn_plan(100, 128, f).grid == 7
    with pytest.raises(ValueError, match="shared memory"):
        ffn_plan(100, 128, f, backward=True)
    assert ffn_plan(100, 128, 192, backward=True).cp == 128


@pytest.mark.parametrize("c,cp,fwd,bwd", [(192, 192, 183808, 203776), (174, 176, 168896, 187584)])
def test_plan_of_the_wide_instances(c, cp, fwd, bwd):
    """The cat_vec widths (F = 192): one block an SM, the whole bf16 W1 and W2
    in shared memory in the forward and in the backward's pass 1 (no W2
    streaming), 12288 rows (TPH's eval B=16 x N=4 x 192 tokens) spread over
    every SM; C = 256 at F = 192 does not fit and raises, and so do the f32
    templates at C = F = 192, whose f32 weights alone are 294912 B."""
    from i2rnet_tpu_torch.ops.cuda.encoder_ffn import check_f32_fits, f32_smem
    from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import f32_smem as d_f32_smem

    plan = ffn_plan(12288, c, 192, backward=True)
    assert (plan.cp, plan.fp, plan.fwd_smem, plan.bwd_smem) == (cp, 192, fwd, bwd)
    assert max(fwd, bwd) <= MAX_SMEM and min(fwd, bwd) > TWO_PER_SM
    assert plan.grid == plan.bwd_grid == 132 and plan.cp64 == 192
    assert 2 * 2 * cp * 192 <= 147456  # the bf16 weights
    with pytest.raises(ValueError, match="shared memory"):
        ffn_plan(12288, 256, 192)
    assert ffn_plan(12288, 256, 64).cp == MAX_CP
    from i2rnet_tpu_torch.ops.cuda.encoder_ffn import WIDE_CP, inst_cp

    # the instances' widths: C padded to 16 to 128, then rounded up to a wide one
    src = (build.CSRC / "ffn_tile.cuh").read_text()
    assert "c <= 176 ? 176 : c <= 192 ? 192 : 256;" in src and WIDE_CP == (176, 192, 256)
    assert all(f"case {w}: return fn(std::integral_constant<int, {w}>{{}});" in src
               for w in WIDE_CP)
    assert [inst_cp(x) for x in (78, 96, 128, 129, 136, 174, 176, 177, 192, 193, 256)] == [
        80, 96, 128, 176, 176, 176, 176, 192, 192, 256, 256]
    for need, what in ((f32_smem(c, 192), "encoder_ffn"),
                       (d_f32_smem(c, 192, backward=True), "encoder_ffn_train")):
        with pytest.raises(ValueError, match="float32"):
            check_f32_fits(c, 192, need, what)
    check_f32_fits(96, 192, d_f32_smem(96, 192, backward=True), "encoder_ffn_train")


def _constants():
    """``constexpr`` ints of ``common.cuh`` and ``ffn_tile.cuh``, evaluated in order."""
    src = "".join((build.CSRC / n).read_text() for n in ("common.cuh", "ffn_tile.cuh"))
    found = {}
    for name, expr in re.findall(r"^constexpr (?:int|size_t) (k\w+) = ([^;]+);", src, re.M):
        found[name] = eval(expr.replace("/", "//"), {"__builtins__": {}}, dict(found))
    return found


def test_plan_limits_are_the_kernel_sources():
    """The plan's constants and shared-memory sums are those the kernels
    compile (``ffn_plan`` picks, ``fits_fwd``/``fits_bwd`` refuse at launch)."""
    k = _constants()
    assert (UNIT, TILE_WARPS, TILE_ROWS, CHUNK, MAX_CP, W_TILE, TWO_PER_SM, MAX_SMEM) == (
        k["kUnit"], k["kTileWarps"], k["kRows"], k["kChunk"], k["kMaxCp"], k["kWTile"],
        k["kTwoPerSm"], k["kMaxSmem"])
    src = (build.CSRC / "ffn_tile.cuh").read_text()
    assert ("return sizeof(bf16) * ((size_t)fp * (cp + 8) + (size_t)cp * (fp + 8) + "
            "(size_t)kRows * (cp + 8)) +\n         sizeof(float) * (fp + 5 * (size_t)cp);" in src)
    assert ("return fwd_smem(cp, fp) + sizeof(uint32_t) * kTileWarps * (fp / kChunk) * 32 +\n"
            "         sizeof(float) * kTileWarps * (5 * (size_t)cp + fp);" in src)
    assert ffn_smem(96, 192, False) == 2 * (192 * 104 + 96 * 200 + 64 * 104) + 4 * (192 + 480)
    assert ffn_smem(96, 192, True) == ffn_smem(96, 192, False) + 4 * 4 * 3 * 32 + 4 * 4 * 672
    # the warps' walk over the units, as the plan describes it, in both kernels
    # (the forward and the backward's pass 1, both in ffn_tile.cuh)
    walk = ("for (long u = blockIdx.x + (long)gridDim.x * warp; u < units; "
            "u += (long)gridDim.x * kTileWarps) {")
    assert src.count(walk) == 2


def test_the_bf16_kernels_launch_once_forward_three_times_backward():
    """Kernel D's bf16 forward is one launch and its backward three (the f32
    template's six); no source of the FFN tail sums with atomics."""
    tile = (build.CSRC / "ffn_tile.cuh").read_text()
    train = (build.CSRC / "encoder_ffn_train.cu").read_text()

    def body(src, head):
        b = src[src.index(head):]
        return b[:b.index("\n}\n")]

    assert body(tile, "cudaError_t launch_fwd(").count("<<<") == 1
    # pass 1 (launch_bwd_rows, for C above 128 through encoder_ffn_train_wide.cu),
    # then passes 2 and 3
    assert body(tile, "cudaError_t launch_bwd_rows(").count("<<<") == 1
    bwd = body(train, "inline cudaError_t launch_bwd(")
    assert bwd.count("<<<") == 2 and "launch_bwd_rows<" in bwd and "i2r_ffn_bwd_rows_wide(" in bwd
    assert "ffn::launch_bwd_rows<" in (build.CSRC / "encoder_ffn_train_wide.cu").read_text()
    for name in ("ffn_tile.cuh", "encoder_ffn.cu", "encoder_ffn_train.cu",
                 "encoder_ffn_train_wide.cu"):
        assert not re.search(r"\batomic\w*\(", (build.CSRC / name).read_text()), name


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float, "unsigned": ctypes.c_uint}


@pytest.mark.parametrize("entry", ["i2r_encoder_ffn_fwd", "i2r_ffn_train_fwd", "i2r_ffn_train_bwd"])
def test_signatures_match_the_ffn_entry_points(entry):
    """The FFN tail's ctypes signatures have the C entry points' arity and
    types; the backward takes the plan's slice rows after its grid."""
    src = "".join((build.CSRC / n).read_text() for n in ("encoder_ffn.cu", "encoder_ffn_train.cu"))
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src, re.S)
    params = [" ".join(q.split()) for q in m.group(1).split(",")]
    assert list(build.SIGNATURES[entry]) == [
        ctypes.c_void_p if "*" in q else _CTYPE[q.split()[0]] for q in params]
    names = [q.split()[-1].lstrip("*") for q in params]
    assert names[names.index("dtype") + 1] == "grid"
    if entry == "i2r_ffn_train_bwd":
        assert names[names.index("grid") + 1] == "slice_rows"


@pytest.mark.parametrize("variant", sorted(ffn_sweep.VARIANTS))
def test_sweep_variants_find_their_text(variant):
    """Each edit of ``probes/ffn_sweep.py`` finds its text in the files it
    edits, as many times as the variant edits it."""
    pkg = build.CSRC.parent
    texts = {f: (pkg / f).read_text() for f in ffn_sweep.FILES}
    for old, new in ffn_sweep.VARIANTS[variant]:
        where = [f for f in ffn_sweep.FILES if old in texts[f]]
        assert where and old != new, old
        texts[where[0]] = texts[where[0]].replace(old, new)


def test_bits_of_the_walk_are_the_plain_versions():
    """The walk's keep masks are the plain version's (``keep_mask`` of the
    same words), so both drop the same elements: a zero cotangent row stays
    zero and the kept share is near 1 - rate."""
    rng = np.random.RandomState(3)
    _, keep, words = _bits(rng, 300, 16, 32)
    for k, w in zip(keep, words):
        assert torch.equal(k, keep_mask(w, RATE))
        assert abs(k.float().mean().item() - (1 - RATE)) < 5 * math.sqrt(RATE * (1 - RATE) / k.numel())
