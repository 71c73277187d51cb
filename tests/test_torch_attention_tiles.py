"""The algorithm of the tensor-core attention kernels, on the CPU.

``csrc/mhsa.cu`` (Kernel A) and ``csrc/mhsa_train.cu`` (Kernel C) run their
bf16 route as a walk over 64-key tiles: the logits scaled in f32 after
``q . K^T`` and kept in base 2 (times log2 e, so each weight is one ex2), an
online softmax from a running max of -1e30 log2 e, the probabilities rounded
to bf16 before ``. V`` (they feed the tensor cores as bf16), and key tiles
that the mask pads entirely skipped where the image has a real key.
The CUDA kernels run only on the card; :func:`tile_attention` here is that
walk in a few lines of torch, held against the port's plain version
(``masked_mhsa_torch``) and the JAX Pallas kernel (interpret mode) on the
same numpy inputs.

Tolerance: rounding each weight ``p`` (at most 1) to bf16 moves it by at
most 2^-9 of itself, so the output moves by at most 2^-9 max|v|; f32 adds
~1e-6. The checks allow 2^-8 max|v|. Skipping is exact: a skipped key's
weight 2^(-1e30 log2 e - m) is 0 in f32 for any running max m above that, and
the dK and dV rows of such keys are exactly 0 (the last test), which is what
lets the backward's dK/dV block write zeros for a skipped tile.
"""

import re

import numpy as np
import pytest
import torch

from i2rnet_tpu.ops.pallas.mhsa import masked_mhsa_pallas
from i2rnet_tpu_torch.ops.cuda import build, mhsa, mhsa_train
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_torch
from i2rnet_tpu_torch.ops.cuda.mhsa_train import masked_mhsa_train_torch

torch.set_num_threads(2)

TILE = 64
LOG2E = 1.4426950408889634
NEG2 = float(torch.tensor(-1e30 * LOG2E, dtype=torch.float32))  # the padded keys' base-2 bias
TOL = 2.0 ** -8  # times max|v|


def tile_attention(q, k, v, num_heads, mask=None, skip=True):
    """Masked MHSA ``[B, S, C]`` as the kernels' bf16 route walks it; returns
    the output and the number of key tiles skipped."""
    b, s, c = q.shape
    h = num_heads
    d = c // h
    scale2 = torch.tensor(1.0 / d ** 0.5, dtype=torch.float32) * LOG2E
    qh, kh, vh = (x.reshape(b, s, h, d).transpose(1, 2).float() for x in (q, k, v))
    pad = torch.zeros(b, s, dtype=torch.bool) if mask is None else mask
    out = torch.empty(b, h, s, d)
    skipped = 0
    for i in range(b):
        has_key = not bool(pad[i].all())
        for hh in range(h):
            m = torch.full((s, 1), NEG2)
            l = torch.zeros(s, 1)
            acc = torch.zeros(s, d)
            for k0 in range(0, s, TILE):
                keys = slice(k0, min(k0 + TILE, s))
                if skip and has_key and bool(pad[i, keys].all()):
                    skipped += 1
                    continue
                logits = (qh[i, hh] @ kh[i, hh, keys].T) * scale2
                logits = logits + torch.where(pad[i, keys], NEG2, 0.0)
                m_new = torch.maximum(m, logits.max(-1, keepdim=True).values)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(logits - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + p.bfloat16().float() @ vh[i, hh, keys]
                m = m_new
            out[i, hh] = acc / l
    return out.transpose(1, 2).reshape(b, s, c), skipped


def _mask(kind, rng, b, s):
    """[B, S] key-padding masks: ``suffix`` (persons of 64 tokens, image 0
    full, the others a prefix of persons), ``scattered`` (whole persons
    padded in the middle), ``all`` (image 0 fully padded), ``random``
    (token-level, S not a multiple of 64, image 0 fully padded)."""
    if kind == "none":
        return None
    if kind == "random":
        mask = rng.rand(b, s) > 0.6
        mask[0] = True
        mask[1:, 3] = False
        return mask
    persons = (np.arange(s) // TILE)[None, :]
    if kind == "suffix":
        return persons >= np.array([s // TILE, 1, 2])[:b, None]
    if kind == "scattered":
        return np.isin(persons, [1, 2]) | (np.arange(b)[:, None] == 1) & (persons == 0)
    mask = persons >= np.array([0, 2, 1])[:b, None]
    assert mask[0].all()
    return mask


def _inputs(rng, b, s, c):
    """q, k, v with values that bf16 holds exactly, as the kernels get them."""
    return [torch.from_numpy(rng.randn(b, s, c).astype(np.float32)).bfloat16().float()
            for _ in range(3)]


# head dims 96, 78, 3; then the wide instances' cat_vec widths, 192 and 174
# (padded to 192: the same walk over a wider head dim)
@pytest.mark.parametrize("c,h", [(96, 1), (78, 1), (24, 8), (192, 1), (174, 1)])
@pytest.mark.parametrize("kind,s", [("suffix", 192), ("scattered", 256), ("all", 192),
                                    ("random", 130), ("none", 130)])
def test_tile_walk_matches_plain_and_pallas(kind, s, c, h):
    rng = np.random.RandomState(s + c)
    b = 3
    q, k, v = _inputs(rng, b, s, c)
    np_mask = _mask(kind, rng, b, s)
    mask = None if np_mask is None else torch.from_numpy(np_mask)
    got, skipped = tile_attention(q, k, v, h, mask)
    assert torch.isfinite(got).all()
    bound = TOL * v.abs().max().item()
    plain = masked_mhsa_torch(q, k, v, h, mask)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=0, atol=bound)
    pallas = np.asarray(masked_mhsa_pallas(q.numpy(), k.numpy(), v.numpy(), h, np_mask,
                                           interpret=True))
    # the Pallas kernel spreads a fully padded image over its 256-padded
    # tile (tests/test_torch_kernels.py::test_plain_mhsa_all_padded_row)
    rows = slice(1, None) if np_mask is not None and np_mask[0].all() else slice(None)
    np.testing.assert_allclose(got.numpy()[rows], pallas[rows], rtol=0, atol=bound)
    want_skips = 0 if np_mask is None else sum(
        int(np_mask[i, k0:k0 + TILE].all()) for i in range(b) if not np_mask[i].all()
        for k0 in range(0, s, TILE)) * h
    assert skipped == want_skips
    if kind in ("suffix", "scattered", "all"):
        assert skipped > 0


def test_skipping_is_exact():
    """With f32 weights (no bf16 rounding), the walk that skips padded tiles
    and the one that visits every tile agree bit for bit, the fully padded
    image included."""
    rng = np.random.RandomState(7)
    q, k, v = _inputs(rng, 3, 256, 16)
    mask = torch.from_numpy(_mask("scattered", rng, 3, 256))
    mask[2] = True
    with torch.no_grad():
        a, n_a = tile_attention(q, k, v, 2, mask, skip=True)
        b, n_b = tile_attention(q, k, v, 2, mask, skip=False)
    assert n_a > 0 and n_b == 0
    assert torch.equal(a, b)
    np.testing.assert_allclose(a[2].numpy(), v[2].mean(0).expand(256, 16).numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dropout", [False, True])
def test_padded_keys_get_exactly_zero_dk_dv(dropout):
    """In an image with a real key, the training attention's gradients at
    its padded keys are exactly 0 in dK and dV (their weight is exactly 0),
    and not at a fully padded image's keys, which are uniform there: the
    dK/dV kernel may write zeros for a skipped tile, never for such an image."""
    rng = np.random.RandomState(3)
    b, s, c, h = 3, 192, 24, 2
    q, k, v = (x.requires_grad_(True) for x in _inputs(rng, b, s, c))
    mask = torch.from_numpy(_mask("all", rng, b, s))
    kw = {}
    if dropout:
        kw = {"dropout_rate": 0.1, "dropout_bits": torch.from_numpy(
            rng.randint(0, 2 ** 32, (b * h, s, s), dtype=np.int64))}
    out = masked_mhsa_train_torch(q, k, v, h, mask, **kw)
    cot = torch.from_numpy(rng.randn(b, s, c).astype(np.float32))
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), cot)
    real = ~mask[1:]
    assert real.any(1).all() and (~real).any()
    for g in (dk[1:], dv[1:]):
        assert (g[~real] == 0).all()
        assert (g[real].abs().sum(-1) > 0).all()
    assert (dv[0].abs().sum(-1) > 0).all()
    assert torch.isfinite(dq).all()


def _constexpr(name, text):
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_wide_instances_fit_and_are_the_wrappers_limits():
    """The head-dim limits of ``csrc/mhsa.cu`` and ``csrc/mhsa_train.cu`` are
    the wrappers' (``check_heads``); every wide instance's shared memory fits
    a block (bf16: A's five tiles, C's six, at padded 192 and 256; f32: C's
    dK/dV block at 192, which is why its f32 limit is 192, and A's tiles at
    256); the dK/dV kernel keeps half the columns a block at 192 and 256."""
    a_src = (build.CSRC / "mhsa.cu").read_text()
    c_src = (build.CSRC / "mhsa_train.cu").read_text()
    assert _constexpr("kMaxHeadDim", a_src) == mhsa.MAX_HEAD_DIM == 256
    assert _constexpr("kMaxHeadDim", c_src) == mhsa_train.MAX_HEAD_DIM == 256
    assert _constexpr("kMaxHeadDimF32", c_src) == mhsa_train.MAX_HEAD_DIM_F32 == 192
    assert "return DP <= 128 ? DP : DP / 2;" in c_src  # dkdv_cols
    max_smem, s = 232448, 768  # the cat_vec inter encoder's tokens at 256x192, N = 4
    scan = -(-s // 16) * 16 + 16
    for dp in (192, 256):
        tile = 2 * 64 * (dp + 8)
        assert 5 * tile + scan <= max_smem  # Kernel A
        assert 6 * tile + 2 * 2 * 64 * 4 + 4 * 64 * 4 + scan <= max_smem  # C forward, dQ
        assert 6 * tile + 6 * 64 * 4 + 4 * 64 * 4 <= max_smem  # C dK/dV
    f32_dkdv = lambda dt: 4 * (4 * 64 * (dt + 1) + 2 * 64 * 65 + 3 * 64)  # noqa: E731
    assert f32_dkdv(192) == 231680 <= max_smem < f32_dkdv(256)
    assert 4 * (3 * 64 * 257 + 64 * 65 + 64) <= max_smem  # A's f32 tiles at 256
    assert mhsa.check_heads(192, 1, 64) == 192 and mhsa.check_heads(174, 1, 64) == 174
    assert mhsa.check_heads(256, 1, 64) == 256
    with pytest.raises(ValueError, match="dim <= 256"):
        mhsa.check_heads(257, 1, 64)
    with pytest.raises(ValueError, match="dim <= 192"):
        mhsa.check_heads(193, 1, 64, mhsa_train.MAX_HEAD_DIM_F32)
