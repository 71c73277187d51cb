"""The port's kernel modules on the CPU: plain versions vs the JAX Pallas
kernels (interpret mode), CPU dispatch of the wrappers, build hygiene.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there. Here the plain versions are held to
the TPU kernels they replace, on the same numpy inputs, in float32:
atol 1e-5 / rtol 1e-4 (two f32 softmax/matmul orders).
"""

import numpy as np
import pytest
import torch

from i2rnet_tpu.ops.attention import masked_mhsa_xla
from i2rnet_tpu.ops.pallas.encoder_ffn import encoder_ffn_fused as jax_encoder_ffn
from i2rnet_tpu.ops.pallas.mhsa import masked_mhsa_pallas
from i2rnet_tpu_torch.ops.attention import masked_mhsa
from i2rnet_tpu_torch.ops.cuda import build, launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused, encoder_ffn_torch
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused, masked_mhsa_torch

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


def _qkv_mask(rng, b, s, c, all_padded_row):
    q, k, v = (rng.randn(b, s, c).astype(np.float32) for _ in range(3))
    mask = rng.rand(b, s) > 0.8
    mask[:, 0] = False
    if all_padded_row:
        mask[-1] = True  # a padded image: every key masked
    return q, k, v, mask


@pytest.mark.parametrize("b,s,c,h", [(2, 36, 16, 2), (1, 300, 96, 1), (2, 130, 24, 8)])
def test_plain_mhsa_matches_pallas(rng, b, s, c, h):
    q, k, v, mask = _qkv_mask(rng, b, s, c, all_padded_row=False)
    ref = np.asarray(masked_mhsa_pallas(q, k, v, h, mask, interpret=True))
    got = masked_mhsa_torch(*map(torch.from_numpy, (q, k, v)), h, torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("b,s,c,h", [(3, 36, 16, 2), (2, 130, 24, 8)])
def test_plain_mhsa_all_padded_row(rng, b, s, c, h):
    """A fully padded image stays finite: its rows average V uniformly over the
    S real keys, as masked_mhsa_xla gives. (The Pallas kernel spreads that
    row over its 256-padded tile instead, an artefact of the TPU tiling; the
    row is zeroed downstream either way.) Rows with a real key match Pallas."""
    q, k, v, mask = _qkv_mask(rng, b, s, c, all_padded_row=True)
    got = masked_mhsa_torch(*map(torch.from_numpy, (q, k, v)), h, torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(masked_mhsa_xla(q, k, v, h, mask)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[-1], np.broadcast_to(v[-1].mean(0), (s, c)),
                               rtol=RTOL, atol=ATOL)
    pallas = np.asarray(masked_mhsa_pallas(q, k, v, h, mask, interpret=True))
    np.testing.assert_allclose(got[:-1], pallas[:-1], rtol=RTOL, atol=ATOL)


def test_plain_mhsa_no_mask(rng):
    q = rng.randn(1, 64, 32).astype(np.float32)
    ref = np.asarray(masked_mhsa_pallas(q, q, q, 4, None, interpret=True))
    t = torch.from_numpy(q)
    np.testing.assert_allclose(masked_mhsa_torch(t, t, t, 4).numpy(), ref, rtol=RTOL, atol=ATOL)


def _ffn_params(rng, c, f):
    return dict(
        n1_scale=rng.uniform(0.5, 1.5, c), n1_bias=0.1 * rng.randn(c),
        w1=rng.randn(c, f) / np.sqrt(c), b1=0.1 * rng.randn(f),
        w2=rng.randn(f, c) / np.sqrt(f), b2=0.1 * rng.randn(c),
        n2_scale=rng.uniform(0.5, 1.5, c), n2_bias=0.1 * rng.randn(c))


@pytest.mark.parametrize("lead,c,f", [((2, 37), 16, 32), ((1, 1344), 96, 192)])
def test_plain_ffn_matches_pallas(rng, lead, c, f):
    x = (2.0 * rng.randn(*lead, c) + 0.5).astype(np.float32)
    p = {k: v.astype(np.float32) for k, v in _ffn_params(rng, c, f).items()}
    ref = np.asarray(jax_encoder_ffn(x, *p.values(), interpret=True))
    t = {k: torch.from_numpy(v) for k, v in p.items()}
    # the port takes torch's Linear layout: w1 [F, C], w2 [C, F]
    got = encoder_ffn_torch(torch.from_numpy(x), t["n1_scale"], t["n1_bias"], t["w1"].T,
                            t["b1"], t["w2"].T, t["b2"], t["n2_scale"], t["n2_bias"]).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_wrappers_take_plain_path_on_cpu(rng):
    """On CPU tensors the kernel wrappers (and the use_kernel dispatch) are
    their plain versions, and no launch is counted."""
    reset_launches()
    q, k, v, mask = map(torch.from_numpy, _qkv_mask(rng, 2, 40, 16, True))
    ref = masked_mhsa_torch(q, k, v, 2, mask)
    assert torch.equal(masked_mhsa_fused(q, k, v, 2, mask), ref)
    assert torch.equal(masked_mhsa(q, k, v, 2, mask, use_kernel=True), ref)
    p = {n: torch.from_numpy(a.astype(np.float32)) for n, a in _ffn_params(rng, 16, 32).items()}
    args = (p["n1_scale"], p["n1_bias"], p["w1"].T, p["b1"], p["w2"].T, p["b2"],
            p["n2_scale"], p["n2_bias"])
    assert torch.equal(encoder_ffn_fused(q, *args), encoder_ffn_torch(q, *args))
    assert launch_counts() == {"masked_mhsa": 0, "encoder_ffn": 0, "mhsa_train_fwd": 0,
                               "mhsa_train_bwd": 0, "encoder_ffn_train_fwd": 0,
                               "encoder_ffn_train_bwd": 0}


def test_wrappers_refuse_other_devices():
    q = torch.empty(1, 8, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        masked_mhsa_fused(q, q, q, 2)
    w = torch.empty(32, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        encoder_ffn_fused(q, None, None, w, None, w.T, None, None, None)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No nvcc -> the build raises; nothing falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    assert {p.name for p in build.sources()} >= {"mhsa.cu", "encoder_ffn.cu"}
    before = build.library_path()
    assert before.parent == build.BUILD_DIR and before == build.library_path()
    for src in build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    (tmp_path / "mhsa.cu").write_text((tmp_path / "mhsa.cu").read_text() + "\n// edit\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.library_path() != before


@pytest.mark.parametrize("name,replaces", [
    ("mhsa.cu", "i2rnet_tpu/ops/pallas/mhsa.py::masked_mhsa_pallas"),
    ("encoder_ffn.cu", "i2rnet_tpu/ops/pallas/encoder_ffn.py::encoder_ffn_fused")])
def test_kernel_sources_carry_their_note(name, replaces):
    head = (build.CSRC / name).read_text().split("#include")[0]
    assert f"Replaces: {replaces}" in head
    assert "What bounds it on the H100" in head
    assert "Design" in head
