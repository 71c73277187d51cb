"""Each ported module vs its JAX counterpart on ``tiny_test_config(5)``.

Same seeded numpy weights (through ``params_from_jax``) and inputs on both
sides, float32. Tolerances: atol 1e-5 / rtol 1e-4 per module (f32 conv and
matmul orders differ between XLA and PyTorch's CPU kernels); decoded
coordinates 1e-3 px.
"""

import jax
import numpy as np
import pytest
import torch

from i2rnet_tpu.models.encoder import TransformerEncoder as JEncoder
from i2rnet_tpu.models.hrnet import HRNetTrunk as JTrunk
from i2rnet_tpu.models.layers import BasicBlock as JBasic
from i2rnet_tpu.models.layers import Bottleneck as JBottleneck
from i2rnet_tpu.models.layers import DeconvBlock as JDeconv
from i2rnet_tpu.models.layers import MaskedBatchNorm as JBN
from i2rnet_tpu.models.position import PositionEmbeddingImage as JPos
from i2rnet_tpu.ops import decode as jdecode
from i2rnet_tpu.ops.flip import flip_back as j_flip_back
from i2rnet_tpu.ops.preprocess import preprocess_inputs as j_preprocess
from i2rnet_tpu.ops.transforms import np_get_affine_transform
from i2rnet_tpu_torch.ops import decode as tdecode
from i2rnet_tpu_torch.ops.flip import flip_back
from i2rnet_tpu_torch.ops.preprocess import preprocess_inputs
from test_torch_bridge import port_model, random_variables, tiny_jax_model

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def tiny():
    cfg, jmodel = tiny_jax_model(use_pallas=True)
    variables = random_variables(jmodel, cfg, seed=1)
    return cfg, variables, port_model(variables, cfg)


def sub(variables, *path):
    out = {}
    for col in ("params", "batch_stats"):
        node = variables.get(col, {})
        for p in path:
            node = node.get(p, {})
        if node:
            out[col] = node
    return out


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def to_nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, ref):
    np.testing.assert_allclose(got, np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_masked_batchnorm(tiny, rng):
    _, v, model = tiny
    x = rng.randn(2, 8, 6, 64).astype(np.float32)
    ref = JBN().apply(sub(v, "trunk", "stem", "conv1", "bn"), x)
    with torch.no_grad():
        close(to_nhwc(model.bn1(nchw(x))), ref)


@pytest.mark.parametrize("which", ["bottleneck_downsample", "basic"])
def test_residual_blocks(tiny, rng, which):
    _, v, model = tiny
    if which == "basic":  # stage3 branch 2 (32 channels)
        jblock, path = JBasic(32), ("trunk", "stage3", "module0", "branch2_block0")
        block, cin = model.stage3[0].branches[2][0], 32
    else:                 # stem layer1_0: Bottleneck(64) with a 1x1 downsample
        jblock, path = JBottleneck(64, downsample=True), ("trunk", "stem", "layer1_0")
        block, cin = model.layer1[0], 64
    x = rng.randn(2, 8, 6, cin).astype(np.float32)
    ref = jblock.apply(sub(v, *path), x)
    with torch.no_grad():
        close(to_nhwc(block(nchw(x))), ref)


def test_hrnet_trunk(tiny, rng):
    cfg, v, model = tiny
    x = rng.randn(1, 64, 48, 3).astype(np.float32)
    refs = jax.jit(JTrunk(cfg.MODEL.EXTRA.to_dict()).apply)(sub(v, "trunk"), x)
    with torch.no_grad():
        outs = model.forward_trunk(nchw(x))
    assert len(outs) == len(refs) == 3
    for got, ref in zip(outs, refs):
        close(to_nhwc(got), ref)


def test_position_embedding(tiny, rng):
    _, v, model = tiny
    pos = rng.rand(2, 3, 64, 48, 1).astype(np.float32)
    ref = JPos((4, 3), 16, mode="conv").apply(sub(v, "multi_pos"), pos)
    with torch.no_grad():
        got = model.position_embedding(torch.from_numpy(pos)).numpy()
    assert got.shape == (2, 3, 4, 3, 16)
    close(got, ref)


@pytest.mark.parametrize("use_pallas", [True, False])
def test_transformer_encoder(tiny, rng, use_pallas):
    """Ragged key masks plus one fully padded image. Against the Pallas
    attention the padded image is left out (its kernel averages that row over
    a 256-padded tile); against the XLA attention every row is compared."""
    _, v, model = tiny
    b, s = 3, 2 * 12
    src = rng.randn(b, s, 16).astype(np.float32)
    pos = rng.randn(b, s, 16).astype(np.float32)
    mask = np.zeros((b, s), bool)
    mask[1, 12:] = True
    mask[2] = True
    ref = np.asarray(JEncoder(2, 2, 32, use_pallas=use_pallas).apply(
        sub(v, "encoder"), src, key_padding_mask=mask, pos=pos, deterministic=True))
    with torch.no_grad():
        got = model.global_encoder(*map(torch.from_numpy, (src, mask, pos))).numpy()
    assert np.isfinite(got).all()
    rows = slice(None) if not use_pallas else slice(0, 2)
    close(got[rows], ref[rows])


def test_deconv_block_twice(tiny, rng):
    _, v, model = tiny
    x = rng.randn(2, 4, 3, 16).astype(np.float32)
    jd = JDeconv(16, kernel=4)
    ref = jd.apply(sub(v, "deconv"), jd.apply(sub(v, "deconv"), x))
    with torch.no_grad():
        got = to_nhwc(model.deconv_layers(model.deconv_layers(nchw(x))))
    assert got.shape == (2, 16, 12, 16)
    close(got, ref)


def _crop_inputs(rng, rotate):
    b, n, rh, rw = 2, 3, 40, 56
    images = rng.randint(0, 256, (b, rh, rw, 3)).astype(np.uint8)
    affs = np.zeros((b, n, 2, 3), np.float32)
    affs[..., 0, 0] = affs[..., 1, 1] = 1.0
    masks = affs.copy()
    boxes = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        for j in range(n - i):  # ragged: the second image has an identity slot
            c = rng.uniform(8, 40, 2)
            s = rng.uniform(0.1, 0.3, 2)
            rot = rng.uniform(-30, 30) if rotate else 0.0
            affs[i, j] = np_get_affine_transform(c, s, rot, (48, 64))
            masks[i, j] = np_get_affine_transform(c, s * 1.5, rot, (48, 64))
            x0, y0 = rng.uniform(0, 20, 2)
            boxes[i, j] = [x0 - 1, y0 - 1, x0 + rng.uniform(5, 30), y0 + rng.uniform(5, 30)]
    return images, affs, boxes, masks


@pytest.mark.parametrize("axis_aligned", [True, False])
def test_preprocess_inputs(rng, axis_aligned):
    args = _crop_inputs(rng, rotate=not axis_aligned)
    rc, rm = jax.jit(j_preprocess, static_argnums=(4, 5))(*args, (48, 64), axis_aligned)
    gc, gm = preprocess_inputs(*map(torch.from_numpy, args), (48, 64), axis_aligned=axis_aligned)
    assert gc.shape == (2, 3, 64, 48, 3) and gm.shape == (2, 3, 64, 48, 1)
    # crops span about [-2.1, 2.6] after normalisation, and the two sides
    # order the bilinear taps' products differently: atol 1e-4 there
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), rtol=RTOL, atol=1e-4)
    close(gm.numpy(), rm)


def test_flip_back(rng):
    heat = rng.randn(2, 3, 5, 16, 12).astype(np.float32)
    pairs = [[1, 2], [3, 4]]
    np.testing.assert_array_equal(flip_back(torch.from_numpy(heat), pairs).numpy(),
                                  np.asarray(j_flip_back(heat, pairs)))


def _heatmaps(rng, p, k, h, w):
    ys, xs = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0, h, (p, k, 1, 1)), rng.uniform(0, w, (p, k, 1, 1))
    heat = np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / 8.0) + 0.02 * rng.randn(p, k, h, w)
    heat[0, 0] = -np.abs(heat[0, 0])  # no positive maximum: coords stay 0
    return heat.astype(np.float32)


@pytest.mark.parametrize("blur,post", [(11, True), (7, True), (5, True), (3, True), (11, False)])
def test_get_final_preds(rng, blur, post):
    heat = _heatmaps(rng, 6, 5, 16, 12)
    centers = rng.uniform(20, 300, (6, 2)).astype(np.float32)
    scales = rng.uniform(0.2, 2.0, (6, 2)).astype(np.float32)
    rc, rv = jdecode.get_final_preds(heat, centers, scales, blur_kernel=blur,
                                     heatmap_size=(12, 16), post_process=post)
    gc, gv = tdecode.get_final_preds(*map(torch.from_numpy, (heat, centers, scales)),
                                     blur_kernel=blur, heatmap_size=(12, 16), post_process=post)
    np.testing.assert_allclose(gc.numpy(), np.asarray(rc), atol=1e-3, rtol=0)
    close(gv.numpy(), rv)


def test_gaussian_blur(rng):
    heat = _heatmaps(rng, 2, 3, 16, 12)
    close(tdecode.gaussian_blur(torch.from_numpy(heat), 11).numpy(),
          jdecode.gaussian_blur(heat, 11))
