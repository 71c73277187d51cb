"""The training kernels' plain versions on the CPU vs the JAX Pallas training
kernels (interpret mode, explicit dropout bits), and the seed-mode bits.

The CUDA kernels (``csrc/mhsa_train.cu``, ``csrc/encoder_ffn_train.cu``) run
only on the card, where ``chip_smoke.py`` holds each against the plain
version here. These tests hold the plain versions to the TPU kernels they
replace on the same numpy inputs and bits, float32, forward and gradients:
atol 1e-5 / rtol 1e-4 (two frameworks' f32 softmax and matmul orders), and
atol 2e-5 / rtol 1e-4 on the FFN tail's weight gradients, sums over all rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2rnet_tpu.ops.pallas.encoder_ffn_train import encoder_ffn_train as jax_ffn_train
from i2rnet_tpu.ops.pallas.mhsa_train import masked_mhsa_train as jax_mhsa_train
from i2rnet_tpu.ops.pallas.prng import threshold as jax_threshold
from i2rnet_tpu_torch.ops.attention import masked_mhsa_train
from i2rnet_tpu_torch.ops.cuda import build, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.dropout import philox4x32, threshold
from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import (encoder_ffn_train_fused,
                                                         encoder_ffn_train_torch, ffn_bits)
from i2rnet_tpu_torch.ops.cuda.mhsa_train import (attention_bits, masked_mhsa_train_fused,
                                                  masked_mhsa_train_torch)

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
BLOCK_Q = 64


def _u32(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _bits_t(bits):
    """numpy uint32 bits as the port's int32 pattern."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int32))


def _torch_grads(fn, inputs, cot):
    xs = [torch.from_numpy(np.asarray(a)).requires_grad_(True) for a in inputs]
    out = fn(*xs)
    return out.detach().numpy(), [g.numpy() for g in torch.autograd.grad(out, xs, cot)]


def _attn_data(rng, b, s, c, h, padded_image):
    q, k, v, g = (rng.randn(b, s, c).astype(np.float32) for _ in range(4))
    mask = rng.rand(b, s) > 0.75
    mask[:, 0] = False
    if padded_image:
        mask[-1] = True
        g[-1] = 0.0  # its output is multiplied by 0 downstream
    s_pad = -(-s // BLOCK_Q) * BLOCK_Q
    return q, k, v, mask, g, _u32(rng, (b * h, s_pad, s_pad))


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("masked", [True, False])
def test_plain_mhsa_train_matches_pallas(rng, rate, masked):
    """Forward and dQ/dK/dV through a random cotangent, H=2, S=100 (no
    multiple of any tile), the JAX kernel's [B*H, S_pad, S_pad] bits sliced."""
    b, s, c, h = 2, 100, 32, 2
    q, k, v, mask, g, bits = _attn_data(rng, b, s, c, h, padded_image=False)
    mask = mask if masked else None

    def jax_fn(q_, k_, v_):
        return jax_mhsa_train(q_, k_, v_, h, key_padding_mask=mask, dropout_rate=rate,
                              dropout_bits=jnp.asarray(bits), block_q=BLOCK_Q, interpret=True)

    ref = np.asarray(jax_fn(q, k, v))
    ref_g = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * g), argnums=(0, 1, 2))(q, k, v)
    tmask = None if mask is None else torch.from_numpy(mask)
    got, got_g = _torch_grads(
        lambda q_, k_, v_: masked_mhsa_train_torch(q_, k_, v_, h, tmask, rate,
                                                   dropout_bits=_bits_t(bits[:, :s, :s])),
        (q, k, v), torch.from_numpy(g))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    for name, a, r in zip("qkv", got_g, ref_g):
        np.testing.assert_allclose(a, np.asarray(r), rtol=RTOL, atol=ATOL, err_msg=f"d{name}")


def test_plain_mhsa_train_fully_padded_image(rng):
    """A fully padded image stays finite (uniform over its S keys, where the
    Pallas kernel spreads over its padded tile), and with its cotangent 0 its
    q, k, v get zero gradients; the other images match Pallas."""
    b, s, c, h = 3, 70, 24, 8
    q, k, v, mask, g, bits = _attn_data(rng, b, s, c, h, padded_image=True)

    def jax_fn(q_, k_, v_):
        return jax_mhsa_train(q_, k_, v_, h, key_padding_mask=mask, dropout_rate=0.1,
                              dropout_bits=jnp.asarray(bits), block_q=BLOCK_Q, interpret=True)

    ref = np.asarray(jax_fn(q, k, v))
    ref_g = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * g), argnums=(0, 1, 2))(q, k, v)
    got, got_g = _torch_grads(
        lambda q_, k_, v_: masked_mhsa_train_torch(q_, k_, v_, h, torch.from_numpy(mask), 0.1,
                                                   dropout_bits=_bits_t(bits[:, :s, :s])),
        (q, k, v), torch.from_numpy(g))
    assert np.isfinite(got).all() and all(np.isfinite(x).all() for x in got_g)
    np.testing.assert_allclose(got[:-1], ref[:-1], rtol=RTOL, atol=ATOL)
    for a, r in zip(got_g, ref_g):
        assert not a[-1].any()
        np.testing.assert_allclose(a[:-1], np.asarray(r)[:-1], rtol=RTOL, atol=ATOL)


def _ffn_params(rng, c, f):
    """JAX layout: w1 [C, F], w2 [F, C]."""
    return [rng.uniform(0.5, 1.5, c), 0.1 * rng.randn(c), rng.randn(c, f) / np.sqrt(c),
            0.1 * rng.randn(f), rng.randn(f, c) / np.sqrt(f), 0.1 * rng.randn(c),
            rng.uniform(0.5, 1.5, c), 0.1 * rng.randn(c)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_ffn_train_matches_pallas(rng, rate):
    """Forward and all nine gradients (x and the eight parameters); the JAX
    kernel's bits, padded to 1024 rows x 128 lanes, sliced to [R, F], [R, C]."""
    lead, c, f = (2, 37), 16, 32
    rows = lead[0] * lead[1]
    x = (2.0 * rng.randn(*lead, c) + 0.5).astype(np.float32)
    p = [a.astype(np.float32) for a in _ffn_params(rng, c, f)]
    g = rng.randn(*lead, c).astype(np.float32)
    bits = (_u32(rng, (1024, 128)), _u32(rng, (1024, 128)))

    def jax_fn(*a):
        return jax_ffn_train(*a, rate, dropout_bits=tuple(map(jnp.asarray, bits)),
                             interpret=True)

    ref = np.asarray(jax_fn(x, *p))
    ref_g = jax.grad(lambda *a: jnp.sum(jax_fn(*a) * g), argnums=tuple(range(9)))(x, *p)
    tp = [p[0], p[1], p[2].T, p[3], p[4].T, p[5], p[6], p[7]]  # torch Linear layout
    tbits = (_bits_t(bits[0][:rows, :f]), _bits_t(bits[1][:rows, :c]))
    got, got_g = _torch_grads(
        lambda *a: encoder_ffn_train_torch(*a, dropout_rate=rate, dropout_bits=tbits),
        (x, *tp), torch.from_numpy(g))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    names = ["x", "n1s", "n1b", "w1", "b1", "w2", "b2", "n2s", "n2b"]
    for name, a, r in zip(names, got_g, ref_g):
        r = np.asarray(r).T if name in ("w1", "w2") else np.asarray(r)
        np.testing.assert_allclose(a, r, rtol=RTOL, atol=2e-5, err_msg=f"d{name}")


def test_philox_known_answers():
    """Philox4x32-10 against the Random123 known-answer vectors."""
    cases = [((0, 0), (0, 0, 0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
             ((0xffffffff,) * 2, (0xffffffff,) * 4, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
             ((0xa4093822, 0x299f31d0), (0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
              (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for key, ctr, want in cases:
        assert tuple(int(w) for w in philox4x32(key, ctr)) == want


def test_seed_bits_are_a_pure_function():
    """The same (seed, offset, index) gives the same bits; another seed or
    offset gives others; each element's bits depend on its own counter only."""
    a = attention_bits(7, 3, 4, 50)
    assert torch.equal(a, attention_bits(7, 3, 4, 50))
    assert (a != attention_bits(8, 3, 4, 50)).float().mean() > 0.99
    assert (a != attention_bits(7, 4, 4, 50)).float().mean() > 0.99
    assert torch.equal(attention_bits(7, 3, 6, 80)[:4, :50, :50], a)
    assert a.min() >= 0 and a.max() < 2 ** 32
    f = ffn_bits(7, 3, 30, 16)
    assert torch.equal(f, ffn_bits(7, 3, 40, 16)[:30])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_seed_keep_fraction(rate):
    """Over 2^20 draws the kept share is 1 - rate within 5 standard
    deviations (sqrt(rate (1 - rate) / n)), and the threshold is prng.py's."""
    assert threshold(rate) == jax_threshold(rate)
    bits = attention_bits(11, 0, 4, 512)
    keep = (bits >= threshold(rate)).double().mean().item()
    assert abs(keep - (1 - rate)) < 5 * np.sqrt(rate * (1 - rate) / bits.numel())


def test_seed_mode_is_bits_mode_with_its_bits(rng):
    """Forward and backward see one mask: the seed-mode output and gradients
    equal the bits-mode ones fed the bits seed mode draws."""
    b, s, c, h = 2, 45, 16, 2
    q, k, v, g = (torch.from_numpy(rng.randn(b, s, c).astype(np.float32)) for _ in range(4))
    mask = torch.from_numpy(rng.rand(b, s) > 0.8)
    bits = attention_bits(21, 5, b * h, s)
    seeded, seeded_g = _torch_grads(
        lambda *a: masked_mhsa_train_torch(*a, h, mask, 0.3, dropout_seed=21, dropout_offset=5),
        (q, k, v), g)
    given, given_g = _torch_grads(
        lambda *a: masked_mhsa_train_torch(*a, h, mask, 0.3, dropout_bits=bits), (q, k, v), g)
    assert np.array_equal(seeded, given)
    assert all(np.array_equal(a, r) for a, r in zip(seeded_g, given_g))

    x = torch.from_numpy(rng.randn(3, 9, c).astype(np.float32))
    p = [torch.from_numpy(a.astype(np.float32)) for a in _ffn_params(rng, c, 32)]
    p[2], p[4] = p[2].T.contiguous(), p[4].T.contiguous()
    fbits = (ffn_bits(4, 8, 27, 32), ffn_bits(4, 9, 27, c))
    gx = torch.from_numpy(rng.randn(3, 9, c).astype(np.float32))
    seeded, seeded_g = _torch_grads(
        lambda *a: encoder_ffn_train_torch(*a, dropout_rate=0.3, dropout_seed=4,
                                           dropout_offset=8), (x, *p), gx)
    given, given_g = _torch_grads(
        lambda *a: encoder_ffn_train_torch(*a, dropout_rate=0.3, dropout_bits=fbits), (x, *p), gx)
    assert np.array_equal(seeded, given)
    assert all(np.array_equal(a, r) for a, r in zip(seeded_g, given_g))
    assert (seeded_g[0] != 0).any()


def test_training_wrappers_take_plain_path_on_cpu(rng):
    """On CPU tensors the training wrappers and the dispatch are their plain
    versions, and no launch is counted."""
    reset_launches()
    q, k, v = (torch.from_numpy(rng.randn(2, 30, 16).astype(np.float32)) for _ in range(3))
    mask = torch.from_numpy(rng.rand(2, 30) > 0.7)
    ref = masked_mhsa_train_torch(q, k, v, 2, mask, 0.2, dropout_seed=3)
    assert torch.equal(masked_mhsa_train_fused(q, k, v, 2, mask, 0.2, dropout_seed=3), ref)
    assert torch.equal(masked_mhsa_train(q, k, v, 2, mask, 0.2, 3, use_kernel=True), ref)
    p = [torch.from_numpy(a.astype(np.float32)) for a in _ffn_params(rng, 16, 32)]
    p[2], p[4] = p[2].T, p[4].T
    assert torch.equal(encoder_ffn_train_fused(q, *p, dropout_rate=0.2, dropout_seed=3),
                       encoder_ffn_train_torch(q, *p, dropout_rate=0.2, dropout_seed=3))
    assert all(n == 0 for n in launch_counts().values())


def test_training_wrappers_refuse():
    """Other devices raise, and a dropout rate needs bits or a seed."""
    q = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        masked_mhsa_train_fused(q, q, q, 2)
    w = torch.empty(32, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        encoder_ffn_train_fused(q, None, None, w, None, w.T, None, None, None)
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="dropout_bits or dropout_seed"):
        masked_mhsa_train_torch(x, x, x, 2, None, 0.1)


@pytest.mark.parametrize("name,replaces", [
    ("mhsa_train.cu", "i2rnet_tpu/ops/pallas/mhsa_train.py::masked_mhsa_train"),
    ("encoder_ffn_train.cu", "i2rnet_tpu/ops/pallas/encoder_ffn_train.py::encoder_ffn_train")])
def test_training_kernel_sources_carry_their_note(name, replaces):
    head = (build.CSRC / name).read_text().split("#include")[0]
    assert f"Replaces: {replaces}" in head
    assert "What bounds it on the H100" in head
    assert "Design" in head
    assert '#include "philox.cuh"' in (build.CSRC / name).read_text()
