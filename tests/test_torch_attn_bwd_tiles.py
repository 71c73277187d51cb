"""The algorithm of kernel 9's bf16 backward on the tensor cores, and its launch plan, on the CPU.

``csrc/window_attn_block_train.cu`` runs the backward of the HRFormer
window-attention training block in five launches. Pass 1 walks each person's
7x7 windows in head groups: da2 = T(s dy) of the window (0 at pad tokens) and
its tokens t2 in tiles of 64 rows, rows 49-63 zero; per head dO = T(da2 .
Wo_h^T) and q, k, v with the head dim zero-padded to a multiple of 16 (weights
and biases zero past d, q pre-scaled), each rounded; the f32 softmax over the
64 tile rows with keys 49-63 masked (the window's pad tokens stay keys, through
the biases); o = T(T(P) . v); dP = dO . v^T; dS = T(P (dP - rowsum(dP P)));
dQ = dS . k, dK = dS^T . q, dV = T(P)^T . dO in f32, rounded into the token
array dqkv [rows, 3, heads, dp] at the window's 49 rows, and their f32 column
sums (the bias gradients) per window. Pass 2 runs dt2 = T(dqkv . Wqkv) over
64-row blocks in column blocks (one f32 sum over all heads, one rounding);
K2 the LayerNorm backward, dx = dy + T(LN1'(dt2)); the weight gradients sum
T(dX)^T t2 and da2^T o over row slices, and the slices in a fixed order. The
CUDA kernels run only on the card; :func:`tile_attn_bwd` is that walk in a
few lines of torch, under the plan of ``ops/cuda/hrformer_block_train.py::
attn_bwd_plan``, held against the port's plain version under autograd
(``window_attn_block_train_torch``) and the JAX Pallas kernel through
``jax.vjp`` in interpret mode, on the same numpy inputs.

Tolerances, of each gradient's max |ref| (dbk, 0 in exact arithmetic, of
dbq's): against the Pallas kernel 2^-8 in bfloat16, because the walk rounds
where its K1 and K2 round, so a value differs only where two f32 summation
orders straddle a rounding boundary of an intermediate (one bf16 step of
that value, which reaches a gradient through sums over many tokens); 1e-5 in
float32, where nothing rounds and only the order of the sums differs.
Against autograd the float32 bound is the same, but in bfloat16 autograd
rounds elsewhere (where the forward casts, not dS or dt2) and keeps dP and
dS unrounded, so the bound there is the 2e-2 of
``tests/test_torch_hrformer_train_kernels.py``.
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

from i2rnet_tpu.ops.pallas.hrformer_block_train import window_attn_block_train as jax_attn_train
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (MAX_COLS, MAX_DP, ROWS, WINDOW,
                                                      layer_norm_f32, pack_attn,
                                                      window_partition, window_unpartition)
from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (K_CHUNK, P_LD, TWO_PER_SM, W_PRODUCTS,
                                                            W_STAGES, W_TILE, attn_bwd_fragments,
                                                            attn_bwd_plan, bwd1_smem,
                                                            window_attn_block_train_torch)
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import MAX_SMEM, pad16
from i2rnet_tpu_torch.probes import attn_bwd_sweep

torch.set_num_threads(2)

TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}  # of max|ref|, against Pallas
AUTOGRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
NAMES = ("x", "ln_w", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
#: (P, H, W, C, heads): head dims 8 and 39, maps that pad to the 7-grid and
#: one that does not (14x14); every map but the one-person one has an s = 0
SHAPES = [(2, 9, 8, 16, 2), (3, 7, 6, 24, 3), (1, 14, 14, 78, 2), (2, 8, 6, 78, 2)]
#: HRFormer-B's four branch maps of a 256x192 input at P=24 persons (B=12 x N=2)
TRAIN_MAPS = [(24, 64, 48, 78, 2), (24, 32, 24, 156, 4), (24, 16, 12, 312, 8),
              (24, 8, 6, 624, 16)]
T = torch.from_numpy


def tile_attn_bwd(x, s, dy, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, plan, eps=1e-6):
    """The gradients of ``x + s * WindowMHSA(LN1(x))`` ``[P, H, W, C]`` for the
    cotangent ``dy`` as the bf16 backward walks them under ``plan``, x's
    dtype as the rounding type (float32: no rounding): (dx, dln_w, dln_b,
    dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo), dx in x's dtype, the rest f32 in
    the torch layouts."""
    dt = x.dtype
    r = lambda a: a.to(dt).float()  # noqa: E731  the value once stored in dt
    p, h, w, c = x.shape
    d, dp, cp, tok = c // heads, pad16(c // heads), pad16(c), WINDOW * WINDOW
    wqkv, bqkv, wot, *_ = pack_attn(wq, bq, wk, bk, wv, bv, wo, bo, heads, dt, "cpu")
    y = layer_norm_f32(x, ln_w, ln_b, eps)
    t2, info = window_partition(r(y), WINDOW)  # the forward's window tokens, pad tokens 0
    da2, _ = window_partition(r(s.float()[:, None, None, None] * dy.float()), WINDOW)
    nb = t2.shape[0]
    tile = lambda a: F.pad(a, (0, cp - c, 0, ROWS - tok))  # noqa: E731  rows 49-63, channels: 0
    tt, dat = tile(t2), tile(da2)
    key_mask = torch.arange(ROWS) >= tok
    # pass 1: the token arrays and the per-window bias sums (dbo: head group 0)
    o3 = torch.full((nb, tok, c), math.nan)
    dqkv = torch.full((nb, tok, 3, heads, dp), math.nan)
    part = torch.full((nb, 4, c), math.nan)
    part[:, 3] = da2.sum(1)
    for hg in range(plan.groups):
        for hd in plan.group_heads(hg):
            def proj(m):  # [64, dp] of q (m = 0), k or v, zero past d
                wm = F.pad(wqkv[:, hd, m].float(), (0, dp - d, 0, cp - c))
                return r(tt @ wm + F.pad(bqkv[hd, m], (0, dp - d)))

            q, k, v = proj(0), proj(1), proj(2)
            do = r(dat @ F.pad(wot[hd * d:(hd + 1) * d].float(), (0, cp - c, 0, dp - d)).t())
            prob = torch.softmax((q @ k.transpose(1, 2)).masked_fill(key_mask, -math.inf), -1)
            o3[:, :, hd * d:(hd + 1) * d] = r(r(prob) @ v)[:, :tok, :d]
            dpm = do @ v.transpose(1, 2)
            ds = r(prob * (dpm - (dpm * prob).sum(-1, keepdim=True)))
            for m, g in enumerate((ds @ k, ds.transpose(1, 2) @ q,
                                   r(prob).transpose(1, 2) @ do)):
                assert not g[:, tok:].any() and not g[:, :, d:].any()  # the paddings stay 0
                dqkv[:, :, m, hd] = r(g[:, :tok])
                part[:, m, hd * d:(hd + 1) * d] = g[:, :, :d].sum(1)
    # pass 2: dt2 = T(dX . Wqkv) in 64-row blocks and the plan's column blocks
    rows, kdim = nb * tok, 3 * heads * dp
    dx_rows = dqkv.reshape(rows, kdim)
    wdt = torch.zeros(3, heads, dp, c)
    wdt[:, :, :d] = wqkv.float().permute(2, 1, 3, 0)
    wdt = wdt.reshape(kdim, c)
    dt2 = torch.full((rows, c), math.nan)
    for rb in range(plan.grid2[0]):
        rs = slice(rb * ROWS, min((rb + 1) * ROWS, rows))
        for cb in range(plan.grid2[1]):
            nt = plan.col_tiles(cb)
            cs = slice(nt.start * 8, min(nt.stop * 8, c))
            dt2[rs, cs] = r(dx_rows[rs] @ wdt[:, cs])
    # K2: LN1's backward on the map, the residual dy
    dtm = window_unpartition(dt2.reshape(nb, tok, c), WINDOW, info)
    xf = x.float()
    diff = xf - xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((diff * diff).mean(-1, keepdim=True) + eps)
    xhat = diff * rstd
    dyg = dtm * ln_w.float()
    dln = rstd * (dyg - dyg.mean(-1, keepdim=True) - xhat * (dyg * xhat).mean(-1, keepdim=True))
    dx = (dy.float() + r(dln)).to(dt)
    # the weight gradients: row slices, summed in order; dWq,k,v's padded rows dropped
    q_scale = 1.0 / math.sqrt(d)
    t2r, da2r, o3r = (a.reshape(rows, c) for a in (t2, da2, o3))
    dxm = dqkv.reshape(rows, 3, heads * dp)
    sums = [0.0] * W_PRODUCTS
    for z in range(plan.grid_w[1]):
        zs = plan.slice_rows(z)
        zs = slice(zs.start, zs.stop)
        for m in range(3):
            sums[m] = sums[m] + dxm[zs, m].t() @ t2r[zs]
        sums[3] = sums[3] + da2r[zs].t() @ o3r[zs]
    unpad = lambda a: a.reshape(heads, dp, c)[:, :d].reshape(c, c)  # noqa: E731
    vec = [sum(part[i, m] for i in range(nb)) for m in range(4)]  # over the windows, in order
    return (dx, (dtm * xhat).sum((0, 1, 2)), dtm.sum((0, 1, 2)), q_scale * unpad(sums[0]),
            q_scale * vec[0], unpad(sums[1]), vec[1], unpad(sums[2]), vec[2], sums[3], vec[3])


def _params(rng, c):
    """LN1 scale/bias and flax-layout projections ([in, out]) with biases."""
    f = lambda: (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)  # noqa: E731
    b = lambda: (0.1 * rng.randn(c)).astype(np.float32)  # noqa: E731
    return [rng.uniform(0.5, 1.5, c).astype(np.float32), b(), f(), b(), f(), b(), f(), b(), f(),
            b()]


def _torch(prm):
    """The port's layouts: Linear weights [out, in]."""
    return [T(np.ascontiguousarray(a.T)) if a.ndim == 2 else T(a) for a in prm]


def _inputs(shape):
    p, h, w, c, _ = shape
    rng = np.random.RandomState(h * 100 + c)
    x = (rng.rand(p, h, w, c) * 2 - 1).astype(np.float32)
    dy = rng.randn(p, h, w, c).astype(np.float32)
    s = np.array([1.25, 0.0, 1.0][:p], np.float32)
    return x, dy, s, _params(rng, c)


_PALLAS = {}


def _pallas_grads(shape, dtype):
    """The JAX Pallas kernel's gradients (interpret mode) in the torch layouts, f32."""
    key = (shape, dtype)
    if key not in _PALLAS:
        x, dy, s, prm = _inputs(shape)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

        def fn(x_, *prm_):
            return jax_attn_train(x_, jnp.asarray(s), *prm_, heads=shape[4], interpret=True)

        _, vjp = jax.vjp(fn, jnp.asarray(x, jdt), *map(jnp.asarray, prm))
        grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, jdt))]
        _PALLAS[key] = [g.T if g.ndim == 2 and i else g for i, g in enumerate(grads)]
    return _PALLAS[key]


def _worst(got, ref):
    """(name, max|err| / max|ref|) of the worst gradient; dbk over dbq's scale."""
    rel = {n: np.abs(a - b).max() / np.abs(ref[4 if n == "bk" else i]).max()
           for i, (n, a, b) in enumerate(zip(NAMES, got, ref))}
    worst = max(rel, key=rel.get)
    return worst, rel[worst]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms", [1, 132])  # all heads of a window in one block; one head a block
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_walk_matches_autograd_and_pallas(shape, sms, dtype):
    p, h, w, c, heads = shape
    x, dy, s, prm = _inputs(shape)
    plan = attn_bwd_plan(p, h, w, c, heads, sms)
    assert plan.group == (heads if sms == 1 else 1)
    xt, dyt = T(x).to(dtype), T(dy).to(dtype)
    got = tile_attn_bwd(xt, T(s), dyt, *_torch(prm), heads, plan)
    assert got[0].dtype == dtype and all(torch.isfinite(g.float()).all() for g in got)
    if p > 1:  # s = 0: the gradient of x is the residual's, dy exactly
        assert torch.equal(got[0][1], dyt[1])
    got = [g.float().numpy() for g in got]
    xs = xt.clone().requires_grad_(True)
    ps = [t.requires_grad_(True) for t in _torch(prm)]
    out = window_attn_block_train_torch(xs, T(s), *ps, heads)
    plain = [g.float().numpy() for g in torch.autograd.grad(out, [xs, *ps], dyt)]
    name, rel = _worst(got, plain)
    assert rel <= AUTOGRAD_TOL[dtype], (name, rel)
    name, rel = _worst(got, _pallas_grads(shape, dtype))
    assert rel <= TOL[dtype], (name, rel)


#: kernel 9's P=24 maps, the odd map of chip_smoke.py, ragged and tiny maps
PLAN_MAPS = TRAIN_MAPS + [(3, 7, 6, 24, 3), (2, 18, 13, 16, 2), (1, 1, 1, 8, 1),
                          (5, 9, 5, 64, 1), (32, 64, 48, 78, 2)]


@pytest.mark.parametrize("shape", PLAN_MAPS)
def test_plan_covers_every_window_head_and_output_once(shape):
    """Pass 1's grid covers each (window, head, person) once; pass 2's each
    (token row, n-tile of dt2) once; the weight gradients' each (output
    tile of each product, token row) once; every block fits its shared memory."""
    p, h, w, c, heads = shape
    plan = attn_bwd_plan(p, h, w, c, heads)
    seen = np.zeros((plan.windows, heads, p), np.int64)
    for bx in range(plan.grid1[0]):
        for person in range(plan.grid1[1]):
            win, hg = bx % plan.windows, bx // plan.windows
            for hd in plan.group_heads(hg):
                seen[win, hd, person] += 1
    assert (seen == 1).all() and heads % plan.group == 0
    out = np.zeros((plan.grid2[0] * ROWS, plan.ntiles), np.int64)
    for rb in range(plan.grid2[0]):
        for cb in range(plan.grid2[1]):
            nt = plan.col_tiles(cb)
            assert 1 <= len(nt) <= plan.cols <= MAX_COLS
            out[rb * ROWS:(rb + 1) * ROWS, nt.start:nt.stop] += 1
    assert (out[:plan.rows] == 1).all() and plan.grid2[0] * ROWS - plan.rows < ROWS
    ntq, ntn = plan.w_tiles
    tiles = np.zeros((W_PRODUCTS, ntq * W_TILE, ntn * W_TILE), np.int64)
    for bx in range(plan.grid_w[0]):  # the q/k/v tiles (three products each), then dWo's
        qkv = bx < ntq * ntn
        t = bx if qkv else bx - ntq * ntn
        m0, n0 = t // ntn * W_TILE, t % ntn * W_TILE
        for prod in (range(3) if qkv else [3]):
            tiles[prod, m0:m0 + W_TILE, n0:n0 + W_TILE] += 1
    mq = heads * pad16(plan.d)
    assert (tiles[:3, :mq, :c] == 1).all() and (tiles[3, :c, :c] == 1).all()
    rows = [r for z in range(plan.grid_w[1]) for r in plan.slice_rows(z)]
    assert rows == list(range(plan.rows)) and plan.grid_w[1] <= plan.slices
    assert plan.per % W_TILE == 0 and plan.part_shape[0] == plan.slices
    assert plan.part_shape[2:] == (max(ntq, ntn) * W_TILE, ntn * W_TILE)
    assert max(plan.smem1, plan.smem2, plan.smem_w) <= MAX_SMEM


def test_plan_fills_the_card_on_the_train_maps():
    """At 256x192's branch maps at P=24 every launch holds at least two
    blocks per SM of 132; pass 1 keeps all heads of a window in a block at
    branches 0-1, groups of 4 heads at 16x12, and one head at 8x6, where two
    heads' dO tiles would not let two blocks share an SM; pass 1's shared
    memory fits two blocks per SM at every map."""
    want = {78: 2, 156: 4, 312: 4, 624: 1}
    for shape in TRAIN_MAPS:
        plan = attn_bwd_plan(*shape, 132)
        assert plan.group == want[plan.c] and plan.d == 39 and pad16(plan.d) == 48
        assert min(plan.blocks1, plan.blocks2, plan.blocks_w) >= 264
        assert plan.smem1 <= TWO_PER_SM
    assert bwd1_smem(624, 39, 2) > TWO_PER_SM


def test_plan_refuses_what_the_body_does_not_take():
    """A head dim past MAX_DP (after padding to 16) or a width whose tiles
    outgrow one block's shared memory has no plan."""
    assert attn_bwd_plan(2, 8, 8, 128, 2).d == 64
    with pytest.raises(ValueError, match="head dims"):
        attn_bwd_plan(2, 8, 8, 130, 2)
    with pytest.raises(ValueError, match="does not fit"):
        attn_bwd_plan(2, 8, 8, 1600, 32)


def _constants():
    """{name: value} of the file-level ``constexpr`` integers of
    ``csrc/common.cuh``, ``csrc/window_attn.cuh`` and
    ``csrc/window_attn_block_train.cu``, in the order they are declared."""
    src = "".join((build.CSRC / n).read_text()
                  for n in ("common.cuh", "window_attn.cuh", "window_attn_block_train.cu"))
    found = {}
    for name, expr in re.findall(r"^constexpr (?:int|size_t) (k\w+) = ([^;]+);", src, re.M):
        expr = expr.replace("/", "//")
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))  # integer arithmetic only
    return found


def test_plan_limits_are_the_kernel_sources():
    """The plan's constants and shared-memory sums are those the kernels
    compile (``attn_bwd_plan`` picks, ``attn_bwd_fits`` refuses at launch)."""
    k = _constants()
    assert (ROWS, MAX_DP, MAX_COLS, MAX_SMEM, WINDOW) == (
        k["kRows"], k["kMaxDp"], k["kMaxCols"], k["kMaxSmem"], k["kWin"])
    assert (P_LD, K_CHUNK, W_TILE, W_STAGES, TWO_PER_SM, W_PRODUCTS) == (
        k["kPLd"], k["kKChunk"], k["kWTile"], k["kWStages"], k["kTwoPerSm"], k["kWProducts"])
    src = (build.CSRC / "window_attn_block_train.cu").read_text()
    assert ("return bwd_region_bytes(c) + sizeof(bf16) * kRows * (amma::pad16(d) + 8) * "
            "(size_t)(3 + group) +\n         sizeof(float) * 4 * 3 * amma::pad16(d) + "
            "sizeof(int) * 2 * kRows;" in src)
    assert "bwd1_smem_bytes(c, c / heads, group) <= kMaxSmem" in src
    assert "return sizeof(bf16) * 2 * kRows * (kKChunk + 8);" in src
    assert "return sizeof(bf16) * kWStages * 4 * kWTile * (kWTile + 8);" in src
    plan = attn_bwd_plan(24, 8, 6, 624, 16)
    assert plan.smem1 == 2 * 64 * (624 + 8) + 2 * 64 * (48 + 8) * 4 + 4 * 12 * 48 + 4 * 2 * 64
    assert attn_bwd_plan(24, 64, 48, 78, 2).smem1 == (2 * 64 * 2 * (64 + 8) + 2 * 64 * 56 * 5
                                                      + 4 * 12 * 48 + 512)
    assert plan.smem2 == 2 * 2 * 64 * (256 + 8) and plan.smem_w == 2 * W_STAGES * 4 * 64 * 72


def test_the_bf16_backward_launches_five_kernels():
    """The bf16 backward makes 5 launches a call (the f32 template 13), and
    none of its kernels sums with atomics."""
    src = (build.CSRC / "window_attn_block_train.cu").read_text()
    body = src[src.index("cudaError_t launch_bwd_bf16("):]
    body = body[:body.index("\n}\n")]
    assert body.count("<<<") == 5
    assert not re.search(r"\batomic\w*\(", src)


def test_fragments_follow_the_mma_operand_layout():
    """The backward's fragments (``mma.sync.m16n8k16`` B registers b0, b1:
    lane l of n-tile j, k-step kk holds M[8j + l // 4, 16kk + 2(l % 4) + (0,
    1, 8, 9)]): dO's per head of the [dp, C] rows of Wo^T of the head's inputs
    (zero past d and past C), dt2's of the [C, 3 heads dp] matrix whose column
    (m heads + hd) dp + i is Wqkv[:, hd, m, i] (zero past d and past C)."""
    rng = np.random.RandomState(5)
    c, heads = 24, 3  # d = 8: padded to 16
    wqkv, _, wot, *_ = pack_attn(*_torch(_params(rng, c))[2:], heads, torch.bfloat16, "cpu")
    wdo, wdt = attn_bwd_fragments(wqkv, wot)
    d, dp, cp, kdim = 8, 16, 32, 3 * heads * 16
    assert wdo.shape == (heads, dp // 8, cp // 16, 32, 4) and wdo.is_contiguous()
    assert wdt.shape == (cp // 8, kdim // 16, 32, 4) and wdt.is_contiguous()
    for lane in range(32):
        for e, off in enumerate((0, 1, 8, 9)):
            k0 = 2 * (lane % 4) + off
            for hd in range(heads):
                for j in range(dp // 8):
                    for kk in range(cp // 16):
                        n, col = 8 * j + lane // 4, 16 * kk + k0
                        want = wot[hd * d + n, col] if n < d and col < c else 0.0
                        assert wdo[hd, j, kk, lane, e] == want
            for j in range(cp // 8):
                for kk in range(kdim // 16):
                    ch, col = 8 * j + lane // 4, 16 * kk + k0
                    (m, hd), i = divmod(col // dp, heads), col % dp
                    want = wqkv[ch, hd, m, i] if i < d and ch < c else 0.0
                    assert wdt[j, kk, lane, e] == want


@pytest.mark.parametrize("variant", sorted(attn_bwd_sweep.VARIANTS))
def test_sweep_variants_find_their_text(variant):
    """Each edit of ``probes/attn_bwd_sweep.py`` finds its text once in the
    files it edits together."""
    pkg = build.CSRC.parent
    src = "".join((pkg / f).read_text() for f in attn_bwd_sweep.FILES)
    for old, new in attn_bwd_sweep.VARIANTS[variant]:
        assert src.count(old) == 1 and old != new


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float, "unsigned": ctypes.c_uint}


def test_signature_matches_the_backward_entry_point():
    """Kernel 9's backward's ctypes signature has the C entry point's arity
    and types, read from ``csrc/window_attn_block_train.cu``; the wrapper
    passes the plan (group, cols, slices) after the heads."""
    src = (build.CSRC / "window_attn_block_train.cu").read_text()
    m = re.search(r'extern "C" int i2r_window_attn_train_bwd\((.*?)\)\s*\{', src, re.S)
    params = [" ".join(q.split()) for q in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in q else _CTYPE[q.split()[0]] for q in params]
    assert list(build.SIGNATURES["i2r_window_attn_train_bwd"]) == want
    names = [q.split()[-1].lstrip("*") for q in params]
    assert names[names.index("heads") + 1:][:3] == ["group", "cols", "slices"]
    assert names[names.index("wot") + 1:][:3] == ["wf", "wdo", "wdt"]
