"""The algorithm of Kernel E's bf16 tensor-core body, and its launch plan, on the CPU.

``csrc/window_attn.cuh`` (Kernel E in bf16, kernel 9's forward and kernel
7's attention phases) runs in two passes. Pass 1 walks each person's 7x7
windows in head groups: the window's 49 LN1 tokens (rounded) in a tile of 64
rows, rows 49-63 zero; per head q, k, v with the head dim zero-padded to a
multiple of 16 (weights and biases zero past d, q pre-scaled by 1/sqrt(d) of
the real d), each rounded; the logits against the 64 tile rows with keys
49-63 masked (the window's pad tokens stay keys, through the biases); the f32
softmax rounded; P.v rounded into the scratch map o at the real tokens. Pass
2 runs the out-projection over the map's rows in column blocks: x + T(o.Wo +
bo), or x + T(s (o.Wo + bo)) with the droppath scale of kernel 9. Where a
block holds all heads of its window, pass 1 runs that out-projection on the
window's 64 rows itself and writes the real tokens (no pass 2). The CUDA
kernel runs only on the card; :func:`tile_attn` is that walk in a few lines
of torch, held against the port's plain version (``window_attn_block_torch``,
``window_attn_block_train_torch``) and the JAX Pallas kernels (interpret
mode) on the same numpy inputs, with the groups and column blocks of
``ops/cuda/hrformer_block.py::attn_plan``.

Tolerances: in bfloat16 the walk and the references round at the same
points, so a value differs only where two f32 summation orders straddle a
rounding boundary of an intermediate (q, k, v, P, o); such a flip moves one
value by one bf16 step and reaches the output through a contraction with
weights of norm about 1, far below one step of the output. The checks allow
2^-8 of max|ref| (one step of the output is at most 2^-7 of its value). In
float32 nothing rounds but the order of the sums: 1e-5 of max|ref|.
"""

import ctypes
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from i2rnet_tpu.ops.pallas.hrformer_block import window_attn_block_fused as jax_window_attn
from i2rnet_tpu.ops.pallas.hrformer_block_train import window_attn_block_train as jax_attn_train
from i2rnet_tpu_torch.ops.cuda import build
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (MAX_COLS, MAX_DP, ROWS, WINDOW,
                                                      attn_fragments, attn_plan, layer_norm_f32,
                                                      pack_attn, window_attn_block_torch,
                                                      window_partition, window_unpartition)
from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import window_attn_block_train_torch
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import MAX_SMEM, pad16
from i2rnet_tpu_torch.probes import attn_sweep

torch.set_num_threads(2)

TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 1e-5}  # of max|ref|
#: the shapes of tests/test_torch_hrformer_kernels.py (P, H, W, C, heads):
#: head dims 8 and 39, maps that pad to the 7-grid and one that does not
SHAPES = [(2, 18, 13, 16, 2), (2, 14, 14, 32, 4), (2, 7, 6, 24, 3), (1, 64, 48, 78, 2)]
#: HRFormer-B's four branch maps of a 256x192 input at P=32 persons
HRT_MAPS = [(32, 64, 48, 78, 2), (32, 32, 24, 156, 4), (32, 16, 12, 312, 8), (32, 8, 6, 624, 16)]
T = torch.from_numpy


def tile_attn(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, plan, s=None, eps=1e-6):
    """``x + WindowMHSA(LN1(x))`` ``[P, H, W, C]`` as the bf16 body walks it
    under ``plan`` (with ``s`` [P], kernel 9's forward: also the window
    tokens t2), x's dtype as the rounding type (float32: no rounding)."""
    dt = x.dtype
    r = lambda a: a.to(dt).float()  # noqa: E731  the value once stored in dt
    p, h, w, c = x.shape
    d, dp = c // heads, pad16(c // heads)
    wqkv, bqkv, wot, bof, *_ = pack_attn(wq, bq, wk, bk, wv, bv, wo, bo, heads, dt, "cpu")
    y = r(layer_norm_f32(x, ln_w, ln_b, eps))
    tok, info = window_partition(y, WINDOW)  # [P * windows, 49, C], pad tokens 0
    tile = F.pad(tok, (0, pad16(c) - c, 0, ROWS - tok.shape[1]))  # rows 49-63 and channels: 0
    o = torch.full((tok.shape[0], tok.shape[1], c), float("nan"))
    key_mask = torch.arange(ROWS) >= WINDOW * WINDOW
    for hg in range(plan.groups):
        for hd in plan.group_heads(hg):
            def proj(m):  # [64, dp] of q (m = 0), k or v, zero past d
                wm = F.pad(wqkv[:, hd, m].float(), (0, dp - d, 0, pad16(c) - c))
                return r(tile @ wm + F.pad(bqkv[hd, m], (0, dp - d)))

            q, k, v = proj(0), proj(1), proj(2)
            logits = (q @ k.transpose(1, 2)).masked_fill(key_mask, -math.inf)
            pv = r(r(torch.softmax(logits, -1)) @ v)
            o[:, :, hd * d:(hd + 1) * d] = pv[:, :WINDOW * WINDOW, :d]
    wom = F.pad(wot.float(), (0, 0, 0, pad16(c) - c))
    scale = torch.ones(p) if s is None else s.float()

    def project(o_rows, x_rows, sc):  # x + T(o.Wo + bo), or x + T(s (o.Wo + bo))
        a = F.pad(o_rows, (0, pad16(c) - c)) @ wom + bof
        return x_rows.float() + r(sc[:, None] * a)

    if plan.fused:  # per window, its 64 rows (the tile's), written at the real tokens
        xw, _ = window_partition(x.float(), WINDOW)
        sw = scale.repeat_interleave(plan.windows)[:, None].expand(-1, ROWS).reshape(-1)
        o64 = F.pad(o, (0, 0, 0, ROWS - o.shape[1])).reshape(-1, c)
        x64 = F.pad(xw, (0, 0, 0, ROWS - o.shape[1])).reshape(-1, c)
        win = project(o64, x64, sw).reshape(o.shape[0], ROWS, c)[:, :WINDOW * WINDOW]
        out = window_unpartition(win, WINDOW, info).reshape(-1, c)
    else:  # pass 2: 64-row blocks of the map's tokens, in column blocks
        om = window_unpartition(o, WINDOW, info).reshape(-1, c)  # the real tokens
        rows, xf = om.shape[0], x.float().reshape(-1, c)
        out = torch.full((rows, c), float("nan"))
        st = scale.repeat_interleave(h * w)
        for rb in range(plan.grid2[0]):
            rs = slice(rb * ROWS, min((rb + 1) * ROWS, rows))
            for cb in range(plan.grid2[1]):
                nt = plan.col_tiles(cb)
                cs = slice(nt.start * 8, min(nt.stop * 8, c))
                out[rs, cs] = project(om[rs], xf[rs], st[rs])[:, cs]
    out = out.reshape(p, h, w, c).to(dt)
    if s is None:
        return out
    return out, tok.to(dt).reshape(p, -1, WINDOW * WINDOW, c)


def _params(rng, c):
    """LN1 scale/bias and flax-layout projections ([in, out]) with biases."""
    f = lambda: (rng.randn(c, c) / np.sqrt(c)).astype(np.float32)  # noqa: E731
    b = lambda: (0.1 * rng.randn(c)).astype(np.float32)  # noqa: E731
    return [rng.uniform(0.5, 1.5, c).astype(np.float32), b(), f(), b(), f(), b(), f(), b(), f(),
            b()]


def _torch(prm):
    """The port's layouts: Linear weights [out, in]."""
    return [T(np.ascontiguousarray(a.T)) if a.ndim == 2 else T(a) for a in prm]


def _jdt(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms", [1, 132])  # all heads in one block; as many groups as it takes
@pytest.mark.parametrize("shape", SHAPES)
def test_tile_walk_matches_plain_and_pallas(shape, sms, dtype):
    p, h, w, c, heads = shape
    rng = np.random.RandomState(h * 100 + c)
    x = (rng.rand(p, h, w, c) * 2 - 1).astype(np.float32)
    prm = _params(rng, c)
    plan = attn_plan(p, h, w, c, heads, sms)
    assert plan.fused == (sms == 1) and plan.group == (heads if sms == 1 else 1)
    xt = T(x).to(dtype)
    got = tile_attn(xt, *_torch(prm), heads, plan)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    got = got.float().numpy()
    plain = window_attn_block_torch(xt, *_torch(prm), heads).float().numpy()
    bound = TOL[dtype] * np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=bound)
    ref = jax_window_attn(jnp.asarray(x, _jdt(dtype)), *prm, heads=heads, interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)), rtol=0, atol=bound)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sms", [1, 132])  # pass 1 with the out-projection; then pass 2
@pytest.mark.parametrize("shape", [(3, 9, 8, 16, 2), (2, 16, 12, 24, 3)])
def test_tile_walk_with_droppath_matches_kernel9_forward(shape, sms, dtype):
    """kernel 9's forward (kTrain): out = x + T(s (o.Wo + bo)) against the
    plain version and the Pallas forward, and the window tokens t2 = T(LN1(x))
    (0 at pad tokens) equal to the plain version's."""
    p, h, w, c, heads = shape
    rng = np.random.RandomState(c)
    x = (rng.rand(p, h, w, c) * 2 - 1).astype(np.float32)
    s = np.array([1.25, 0.0, 1.0][:p], np.float32)
    prm = _params(rng, c)
    xt = T(x).to(dtype)
    got, t2 = tile_attn(xt, *_torch(prm), heads, attn_plan(p, h, w, c, heads, sms), s=T(s))
    assert torch.equal(got[1], xt[1])  # s = 0: exactly x
    got = got.float().numpy()
    plain = window_attn_block_train_torch(xt, T(s), *_torch(prm), heads).float().numpy()
    bound = TOL[dtype] * np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=bound)
    ref = jax_attn_train(jnp.asarray(x, _jdt(dtype)), jnp.asarray(s), *prm, heads=heads,
                         interpret=True)
    np.testing.assert_allclose(got, np.asarray(ref.astype(jnp.float32)), rtol=0, atol=bound)
    y = layer_norm_f32(xt, *_torch(prm)[:2]).to(dtype)
    assert torch.equal(t2.reshape(-1, WINDOW * WINDOW, c), window_partition(y, WINDOW)[0])


#: 384x288's branch 0, the odd map of chip_smoke.py, kernel 9's P=24 maps, ragged maps
PLAN_MAPS = HRT_MAPS + [(8, 96, 72, 78, 2), (3, 7, 6, 24, 3), (24, 8, 6, 624, 16),
                        (24, 64, 48, 78, 2), (2, 18, 13, 16, 2), (1, 1, 1, 8, 1),
                        (5, 9, 5, 64, 1)]


@pytest.mark.parametrize("shape", PLAN_MAPS)
def test_plan_covers_every_window_head_and_output_once(shape):
    """Pass 1's grid covers each (window, head, person) once; pass 2's each
    (token row, output n-tile) once; both fit a block's shared memory."""
    p, h, w, c, heads = shape
    plan = attn_plan(p, h, w, c, heads)
    seen = np.zeros((plan.windows, heads, p), np.int64)
    for bx in range(plan.grid1[0]):
        for person in range(plan.grid1[1]):
            win, hg = bx % plan.windows, bx // plan.windows
            for hd in plan.group_heads(hg):
                seen[win, hd, person] += 1
    assert (seen == 1).all() and heads % plan.group == 0
    assert plan.smem1 <= MAX_SMEM and plan.smem2 <= MAX_SMEM
    if plan.fused:  # pass 1 writes every real token's output columns itself
        assert plan.grid2 == (0, 0)
        return
    rows = p * h * w
    out = np.zeros((plan.grid2[0] * ROWS, plan.ntiles), np.int64)
    for rb in range(plan.grid2[0]):
        for cb in range(plan.grid2[1]):
            nt = plan.col_tiles(cb)
            assert 1 <= len(nt) <= plan.cols <= MAX_COLS
            out[rb * ROWS:(rb + 1) * ROWS, nt.start:nt.stop] += 1
    assert (out[:rows] == 1).all() and plan.grid2[0] * ROWS - rows < ROWS


def test_plan_fills_the_card_on_hrt_maps():
    """At 256x192's branch maps at P=32, each pass holds at least two blocks
    per SM of 132, with all heads of a window in a block (and no pass 2) on
    the maps that have windows enough (branches 0-1) and groups of 4 and 2
    heads on 16x12 and 8x6; shared memory fits 227 KB (two blocks per SM of
    pass 1 at every map)."""
    want = {78: 2, 156: 4, 312: 4, 624: 2}
    for p, h, w, c, heads in HRT_MAPS:
        plan = attn_plan(p, h, w, c, heads, 132)
        assert plan.group == want[c] and plan.d == 39 and pad16(plan.d) == 48
        assert plan.fused == (c < 312) and plan.blocks1 >= 264
        assert plan.fused or plan.blocks2 >= 132
        assert 2 * plan.smem1 <= 227 * 1024 and plan.smem2 <= MAX_SMEM
    assert attn_plan(32, 8, 6, 624, 16, 132).blocks1 >= 132


def test_plan_refuses_what_the_body_does_not_take():
    """A head dim past MAX_DP (after padding to 16) or a width whose tiles
    outgrow one block's shared memory has no plan."""
    assert attn_plan(2, 8, 8, 128, 2).d == 64
    with pytest.raises(ValueError, match="head dims"):
        attn_plan(2, 8, 8, 130, 2)
    with pytest.raises(ValueError, match="does not fit"):
        attn_plan(2, 8, 8, 1600, 32)


def _cuh_constants():
    """{name: value} of the ``constexpr`` integers of ``csrc/common.cuh`` and
    ``csrc/window_attn.cuh``, in the order they are declared."""
    src = "".join((build.CSRC / n).read_text() for n in ("common.cuh", "window_attn.cuh"))
    found = {}
    for name, expr in re.findall(r"constexpr (?:int|size_t) (k\w+) = ([^;]+);", src):
        expr = expr.replace("/", "//")
        found[name] = eval(expr, {"__builtins__": {}}, dict(found))  # integer arithmetic only
    return found


def test_plan_limits_are_the_kernel_sources():
    """The plan's constants and shared-memory sums are those the kernels
    compile (``attn_plan`` picks, ``attn_mma_fits`` refuses at launch)."""
    k = _cuh_constants()
    assert (ROWS, MAX_DP, MAX_COLS, MAX_SMEM, WINDOW) == (
        k["kRows"], k["kMaxDp"], k["kMaxCols"], k["kMaxSmem"], k["kWin"])
    assert k["kProjTiles"] * k["kWarps"] * 8 == 3 * MAX_DP and k["kPvTiles"] * 16 == MAX_DP
    src = (build.CSRC / "window_attn.cuh").read_text()
    assert ("((fused ? 2 : 1) * (amma::pad16(c) + 8) + 3 * (amma::pad16(d) + 8)) +\n"
            "         sizeof(int) * 2 * kRows" in src)
    assert "return sizeof(__nv_bfloat16) * kRows * (amma::pad16(c) + 8);" in src
    assert "attn_mma_smem_bytes(c, c / heads, group == heads) <= kMaxSmem" in src
    plan = attn_plan(32, 8, 6, 624, 16)
    assert not plan.fused and plan.smem1 == 2 * 64 * (624 + 8 + 3 * (48 + 8)) + 4 * 2 * 64
    assert plan.smem2 == 2 * 64 * (624 + 8)
    assert attn_plan(32, 64, 48, 78, 2).smem1 == 2 * 64 * (2 * (80 + 8) + 3 * (48 + 8)) + 512


def test_fragments_follow_the_mma_operand_layout():
    """Head hd's q/k/v fragments: lane l of n-tile j, k-step kk holds M[8j +
    l // 4, 16kk + 2(l % 4) + (0, 1, 8, 9)] (``mma.sync.m16n8k16`` B
    registers b0, b1) of the [3 dp, C] matrix whose row m dp + i is output i
    of q (m = 0), k or v, zero past d and past C; Wo's likewise of [C, C]."""
    rng = np.random.RandomState(3)
    c, heads = 24, 3  # d = 8: padded to 16
    prm = _torch(_params(rng, c))
    wqkv, _, wot, _, wf, wof = pack_attn(*prm[2:], heads, torch.bfloat16, "cpu")
    assert torch.equal(wf, attn_fragments(wqkv, wot)[0])
    d, dp, cp = 8, 16, 32
    assert wf.shape == (heads, 3 * dp // 8, cp // 16, 32, 4) and wf.is_contiguous()
    assert wof.shape == (cp // 8, cp // 16, 32, 4)
    for hd in range(heads):
        for j in range(3 * dp // 8):
            for kk in range(cp // 16):
                for lane in range(32):
                    row = 8 * j + lane // 4
                    m, i = divmod(row, dp)
                    for e, off in enumerate((0, 1, 8, 9)):
                        col = 16 * kk + 2 * (lane % 4) + off
                        want = wqkv[col, hd, m, i] if i < d and col < c else 0.0
                        assert wf[hd, j, kk, lane, e] == want
                        wo_want = wot[col, row] if row < c and col < c else 0.0
                        if j < cp // 8:
                            assert wof[j, kk, lane, e] == wo_want
    f32 = pack_attn(*prm[2:], heads, torch.float32, "cpu")
    assert len(f32) == 6 and f32[4].numel() == 0 and f32[5].numel() == 0


@pytest.mark.parametrize("variant", sorted(attn_sweep.VARIANTS))
def test_sweep_variants_find_their_text(variant):
    """Each edit of ``probes/attn_sweep.py`` finds its text once in the files
    it edits together."""
    pkg = build.CSRC.parent
    src = "".join((pkg / f).read_text() for f in attn_sweep.FILES)
    for old, new in attn_sweep.VARIANTS[variant]:
        assert src.count(old) == 1 and old != new


_CTYPE = {"int": ctypes.c_int, "float": ctypes.c_float, "unsigned": ctypes.c_uint}


@pytest.mark.parametrize("entry", ["i2r_window_attn_fwd", "i2r_window_attn_train_fwd",
                                   "i2r_full_block_fwd", "i2r_full_block_plan"])
def test_signatures_match_the_window_attention_entry_points(entry):
    """E's, kernel 9's forward's and kernel 7's ctypes signatures have the C
    entry points' arity and types, read from ``csrc/*.cu``, and the wrappers
    pass them the plan (group, cols) after the heads."""
    src = "".join(p.read_text() for p in build.sources())
    m = re.search(r'extern "C" int ' + entry + r"\((.*?)\)\s*\{", src, re.S)
    params = [" ".join(q.split()) for q in m.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in q else _CTYPE[q.split()[0]] for q in params]
    assert list(build.SIGNATURES[entry]) == want
    names = [q.split()[-1].lstrip("*") for q in params]
    assert names[names.index("heads") + 1:][:2] in (["group", "cols"], ["dh", "group"])
