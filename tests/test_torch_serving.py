"""The port's serve path vs the jitted JAX ``make_serve_fn`` on the tiny
model (Pallas kernels in interpret mode): preprocess -> forward -> flip test
-> DARK decode, on uniform and ragged batches with a fully padded image; and
the in-process ``Predictor``'s bucket routing and chunking.

Tolerances: decoded coordinates 1e-3 px, confidences atol 1e-5 / rtol 1e-4
(float32 on both sides).
"""

import jax
import numpy as np
import pytest
import torch

from i2rnet_tpu.serving import make_serve_fn as jax_make_serve_fn
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.serving import Predictor, boxes_to_person_meta, make_serve_fn
from test_torch_bridge import port_model, random_variables, tiny_jax_model

torch.set_num_threads(2)

RAW_H, RAW_W = 96, 128
FLIP_PAIRS = [[1, 2], [3, 4]]  # COCO's pairs that fall within K=5


@pytest.fixture(scope="module")
def served():
    cfg, jmodel = tiny_jax_model(use_pallas=True)
    variables = random_variables(jmodel, cfg, seed=3)
    argmax_cfg = cfg.clone()
    argmax_cfg.TEST.POST_PROCESS = False
    jserve = {post: jax.jit(lambda *a, c=c: jax_make_serve_fn(c, jmodel, FLIP_PAIRS)(variables, *a))
              for post, c in ((True, cfg), (False, argmax_cfg))}
    return cfg, argmax_cfg, jserve, port_model(variables, cfg)


def _batch(rng, n_per_image, n):
    """Host arrays for one static (B, n) call, as Predictor lays them out."""
    b = len(n_per_image)
    imgs = rng.randint(0, 256, (b, RAW_H, RAW_W, 3)).astype(np.uint8)
    affs = np.zeros((b, n, 2, 3), np.float32)
    affs[..., 0, 0] = affs[..., 1, 1] = 1.0
    rects = np.zeros((b, n, 4), np.float32)
    valid = np.zeros((b, n), bool)
    cent = np.zeros((b * n, 2), np.float32)
    scal = np.ones((b * n, 2), np.float32)
    masks = affs.copy()
    for r, m in enumerate(n_per_image):
        if m == 0:
            continue
        boxes = [[4.0 + 9 * i, 3.0 + 5 * i, 40.0 + 3 * i, 60.0 - 2 * i] for i in range(m)]
        c, s, a, rect = boxes_to_person_meta(boxes, (48, 64))
        affs[r, :m], rects[r, :m], valid[r, :m] = a, rect, True
        masks[r] = [[48 / RAW_W, 0, 0.5 * 48 / RAW_W - 0.5], [0, 64 / RAW_H, 0.5 * 64 / RAW_H - 0.5]]
        cent[r * n:r * n + m], scal[r * n:r * n + m] = c, s
    return imgs, affs, rects, masks, valid, cent, scal


@pytest.mark.parametrize("n_per_image", [(3, 3, 3), (3, 1, 0)], ids=["uniform", "ragged"])
def test_serve_matches_jax(served, rng, n_per_image):
    """Argmax decode (POST_PROCESS false): every coordinate within 1e-3 px.
    DARK decode: confidences equal, and coordinates within 1e-3 px wherever
    the JAX Taylor step stays within one heatmap pixel of the argmax. Where
    it jumps further, the Hessian at the argmax is near singular (these
    random-weight heatmaps are not the peaked maps of a trained model) and
    f32 rounding decides the step on either side; those are held finite."""
    cfg, argmax_cfg, jserve, model = served
    args = _batch(rng, n_per_image, 3)
    padded = ~args[4].reshape(-1)
    got = {}
    for post, c in ((False, argmax_cfg), (True, cfg)):
        serve = make_serve_fn(presets.from_config(c), model, FLIP_PAIRS)
        gc, gv = (t.numpy() for t in serve(*map(torch.from_numpy, args)))
        rc, rv = map(np.asarray, jserve[post](*args))
        assert gc.shape == (len(n_per_image) * 3, 5, 2) and gv.shape == (len(n_per_image) * 3, 5, 1)
        assert np.isfinite(gc).all() and np.isfinite(gv).all()
        assert not gc[padded].any() and not gv[padded].any()
        np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=1e-4)
        got[post] = gc, rc
    np.testing.assert_allclose(*got[False], atol=1e-3, rtol=0)
    (gc, rc), (_, r_argmax) = got[True], got[False]
    px = (args[6][:, :1] * 200 - 1) / (16 - 1)  # source px per heatmap px (x)
    within = np.all(np.abs(rc - r_argmax) <= px[:, None, :], axis=-1)
    assert within[~padded].mean() >= 0.3  # about half of these random maps
    np.testing.assert_allclose(gc[within], rc[within], atol=1e-3, rtol=0)


def test_predictor_routing_and_chunking(served, rng):
    """Rows go to the smallest bucket that holds them, 5 boxes split 3 + 2,
    no boxes means the whole image. Batching images together and padding a
    row into a larger bucket leave each result as it was (up to f32 noise):
    images share no computation, and padded persons are masked keys."""
    _, argmax_cfg, _, model = served
    pcfg = presets.from_config(argmax_cfg)  # argmax decode: see test_serve_matches_jax

    def predictor(batch_images, n_buckets):
        return Predictor(model, pcfg, FLIP_PAIRS, batch_images=batch_images,
                         n_buckets=n_buckets, raw_hw=(RAW_H, RAW_W))

    pred = predictor(2, (3, 2))
    calls = []
    serve = pred.serve
    pred.serve = lambda *a: calls.append(tuple(a[4].shape)) or serve(*a)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((80, 120), (64, 64), (96, 128))]
    boxes = [[[5.0 + 7 * i, 4.0 + 3 * i, 35.0, 50.0] for i in range(5)],
             [[2.0, 2.0, 30.0, 40.0]],
             []]
    out = pred.predict(images, boxes)
    assert [o.shape for o in out] == [(5, 5, 3), (1, 5, 3), (1, 5, 3)]
    assert np.isfinite(np.concatenate(out)).all()
    # rows: img0 3 + 2 boxes, img1 1 box, img2 whole image -> bucket 2 gets
    # three rows (two calls of B=2), bucket 3 one row
    assert sorted(calls) == [(2, 2), (2, 2), (2, 3)]
    alone = predictor(1, (3, 2)).predict(images, boxes)
    wider = predictor(1, (3,)).predict(images[1:], boxes[1:])
    for got, ref in zip(out + out[1:], alone + wider):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_predictor_rejects_bad_requests(served):
    cfg, _, _, model = served
    pred = Predictor(model, presets.from_config(cfg), FLIP_PAIRS, batch_images=1,
                     n_buckets=(2,), raw_hw=(RAW_H, RAW_W))
    with pytest.raises(ValueError, match="length mismatch"):
        pred.predict([np.zeros((8, 8, 3), np.uint8)], [])
    with pytest.raises(ValueError, match="uint8"):
        pred.predict([np.zeros((8, 8, 3), np.float32)], [[]])
    with pytest.raises(ValueError, match="exceeds the canvas"):
        pred.predict([np.zeros((RAW_H + 1, 8, 3), np.uint8)], [[]])


def test_predictor_serves_the_hrt_model_as_jax(rng):
    """The HRFormer two-stage model (tiny HRFormer, Kernels E and F's routes)
    behind ``Predictor``: every static call it makes, fed to the jitted JAX
    serve function of the same weights (fused Pallas blocks in interpret
    mode), gives the same keypoints. Argmax decode, as the routing test."""
    from i2rnet_tpu.presets import tiny_test_config
    from test_torch_hrformer import _person_inputs, init, jax_interformer, port_interformer

    jmodel = jax_interformer("block")
    variables = init(jmodel, *_person_inputs(np.random.RandomState(0), np.ones((1, 2), bool)),
                     train=False, seed=6)
    jcfg = tiny_test_config(5)  # the tiny HRT config's input, heatmap and TEST keys
    jcfg.TEST.POST_PROCESS = False
    jserve = jax.jit(lambda *a: jax_make_serve_fn(jcfg, jmodel, FLIP_PAIRS)(variables, *a))
    model = port_interformer(variables, "block")
    pcfg = presets.tiny_hrt_config(5)
    pcfg["TEST"]["POST_PROCESS"] = False
    pred = Predictor(model, pcfg, FLIP_PAIRS, batch_images=2, n_buckets=(2, 3),
                     raw_hw=(RAW_H, RAW_W))
    calls = []
    serve = pred.serve

    def spy(*a):
        out = serve(*a)
        calls.append(([t.numpy() for t in a], [t.numpy() for t in out]))
        return out

    pred.serve = spy
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in ((80, 120), (96, 128))]
    boxes = [[[5.0 + 7 * i, 4.0 + 3 * i, 35.0, 50.0] for i in range(3)], [[2.0, 2.0, 30.0, 40.0]]]
    out = pred.predict(images, boxes)
    assert [o.shape for o in out] == [(3, 5, 3), (1, 5, 3)] and calls
    for args, (gc, gv) in calls:
        rc, rv = map(np.asarray, jserve(*args))
        np.testing.assert_allclose(gc, rc, atol=1e-3, rtol=0)
        np.testing.assert_allclose(gv, rv, atol=1e-5, rtol=1e-4)
        assert np.abs(rv).max() > 0.05
