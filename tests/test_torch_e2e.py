"""The end-to-end I²R-Net (``interformer_e2e``, ``interformer_e2e_new``) vs JAX.

Both names at a tiny config like ``tests/test_e2e_model.py`` (the tiny HRNet
trunk, 64x48 input, d_model 16; one intra and one inter layer; ``_new`` with
``DOMAIN_TRANS``), with the JAX weights carried across by
``params_from_jax``:

* the forward (``single`` and ``multi``, padded persons zeroed) within 1e-5
  of the largest value (f32);
* a training forward at dropout 0 (the JAX model on its Pallas training
  kernels in interpret mode at rate 0, ``test_torch_train_step.
  jax_dropout_zero``): the loss (``LOSS_WEIGHTS`` over ``single`` and
  ``multi``, rtol 1e-5), every gradient (rtol 1e-3, atol 1e-3 of the
  tensor's largest value; in the HRNet trunk 10% and an L2 error under 5%,
  the ReLU-kink flips ``test_torch_train_step.py`` measures) and every
  BatchNorm's running statistics against Flax's ``batch_stats`` (rtol 1e-4,
  atol 1e-6), the shared deconv block's moved once per application;
* the ``convert_state_dict`` / ``params_from_jax`` round trip bit for bit,
  and the bridge at full width (``presets.e2e_w48``, shapes only);
* ``validate`` of the tiny model on the committed COCO fixture against the
  JAX ``validate`` on the same weights (the ``multi`` heatmaps decoded), and
  ``Predictor`` serving it.
"""

import jax
import numpy as np
import pytest
import torch

from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.core.train import compute_losses as j_compute_losses
from i2rnet_tpu.core.validate import validate as jax_validate
from i2rnet_tpu.data.coco import COCODataset as JaxCOCO
from i2rnet_tpu.presets import tiny_test_config
from i2rnet_tpu.registry import get_model_builder
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.core.train import compute_losses
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.interformer_e2e import InterFormerE2E
from i2rnet_tpu_torch.registry import get_model_builder as port_builder
from i2rnet_tpu_torch.serving import Predictor
from test_torch_bridge import random_variables
from test_torch_train_step import _grad_noise, _leaves, jax_dropout_zero  # noqa: F401
from torch_fixture import FIXTURE

torch.set_num_threads(2)

NAMES = ["interformer_e2e", "interformer_e2e_new"]


def jax_cfg(name, **changes):
    cfg = tiny_test_config(num_joints=5).clone()
    cfg.MODEL.NAME = name
    cfg.MODEL.ENCODER_SINGLE_LAYERS = 1
    cfg.MODEL.ENCODER_MUTI_LAYERS = 1
    cfg.MODEL.SINGLE_POS_EMBEDDING = "sine"
    cfg.MODEL.DOMAIN_TRANS = name == "interformer_e2e_new"
    cfg.MODEL.HRNET_RES_LAYER = 0
    for key, v in changes.items():
        sec, k = key.split(".")
        setattr(getattr(cfg, sec), k, v)
    return cfg


def models(name, use_pallas=False, seed=1, **changes):
    jcfg = jax_cfg(name, **changes)
    jmodel = get_model_builder(name)(jcfg, use_pallas=use_pallas)
    variables = random_variables(jmodel, jcfg, seed=seed)
    model = build_model(presets.from_config(jcfg), device="cpu")
    model.load_state_dict(params_from_jax(variables, name), strict=True)
    return jcfg, jmodel, variables, model


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(2, 3, 64, 48, 3).astype(np.float32)
    pos = (rng.rand(2, 3, 64, 48, 1) > 0.5).astype(np.float32)
    valid = np.array([[True, True, False], [True, False, False]])
    return images, pos, valid


@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name):
    jcfg, jmodel, variables, model = models(name)
    assert isinstance(model, InterFormerE2E) and port_builder(name)
    assert model.separate_heads == (name == "interformer_e2e_new")
    images, pos, valid = inputs()
    want = jmodel.apply(variables, images, pos, valid, train=False)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in (images, pos, valid)))
    for k in ("single", "multi"):
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape == (2, 3, 5, 16, 12)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=k)
        assert not g[~valid].any()


def _port_grads(model, name):
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    for n, p in model.named_parameters():
        sd[n] = np.zeros(p.shape) if p.grad is None else p.grad.detach().double().numpy()
    tree, unmatched = convert_state_dict(sd, name)
    assert not unmatched
    return tree["params"]


@pytest.mark.parametrize("name", NAMES)
def test_training_forward_and_gradients_match_jax(name, jax_dropout_zero):
    jcfg, jmodel, variables, model = models(name, use_pallas=True, seed=2)
    images, pos, valid = inputs(1)
    rng = np.random.RandomState(4)
    batch = {"images": images, "pos_masks": pos, "person_valid": valid,
             "target": rng.rand(2, 3, 5, 16, 12).astype(np.float32),
             "target_weight": (rng.rand(2, 3, 5) > 0.2).astype(np.float32)}
    weights = (0.3, 0.7)

    def j_loss(params):
        out, upd = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                images, pos, valid, train=True, mutable=["batch_stats"],
                                rngs={"dropout": jax.random.PRNGKey(0)})
        return j_compute_losses(out, batch, weights, True)[0], upd["batch_stats"]

    (jloss, jstats), jgrads = jax.value_and_grad(j_loss, has_aux=True)(variables["params"])

    for encoder in model.encoders():
        encoder.dropout_rate = 0.0
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = model(tb["images"], tb["pos_masks"], tb["person_valid"], train=True, dropout_seed=0)
    loss, parts = compute_losses(out, tb, weights, True)
    assert set(parts) == {"loss_single", "loss_multi"}
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)

    got = _port_grads(model, name)
    assert len(_leaves(got)) == len(_leaves(jgrads))
    for (path, a), (_, r) in zip(_leaves(got), _leaves(jgrads)):
        key, r = jax.tree_util.keystr(path), np.asarray(r, np.float64)
        np.testing.assert_allclose(a, r, rtol=1e-3, atol=_grad_noise(key, r), err_msg=key)
        if key.startswith("['trunk']"):
            assert np.linalg.norm(a - r) <= 0.05 * np.linalg.norm(r), key

    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    stats, _ = convert_state_dict(sd, name)
    for (path, a), (_, r) in zip(_leaves(stats["batch_stats"]), _leaves(jstats)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    # the shared deconv ran log2(12 / 3) = 2 times after the inter encoder
    assert int(model.deconv_layers[1].num_batches_tracked) == model.pool_steps == 2


@pytest.mark.parametrize("name", NAMES)
def test_round_trip_is_exact(name):
    jcfg, _, variables, model = models(name)
    sd = {k: v.numpy() for k, v in params_from_jax(variables, name).items()}
    assert set(sd) == set(model.state_dict())
    back, unmatched = convert_state_dict(sd, name, strict=True)
    assert unmatched == []
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (path, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", NAMES)
def test_bridge_covers_the_full_width_model(name):
    """``presets.e2e_w48`` against the JAX W48 preset with the same model keys
    (shapes only): every JAX leaf maps to a port tensor of the same name and
    shape, and ``from_config`` gives the preset's model section."""
    from i2rnet_tpu.presets import w48_pure_en6

    jcfg = w48_pure_en6()
    for k, v in (("NAME", name), ("ENCODER_SINGLE_LAYERS", 4), ("ENCODER_MUTI_LAYERS", 2),
                 ("SINGLE_POS_EMBEDDING", "sine"), ("HRNET_RES_LAYER", 0),
                 ("DOMAIN_TRANS", False)):
        setattr(jcfg.MODEL, k, v)
    cfg = presets.e2e_w48(name)
    got = presets.from_config(jcfg)["MODEL"]
    for k, v in cfg["MODEL"].items():  # EXTRA: the keys the port reads
        assert ({ek: got[k][ek] for ek in v} if k == "EXTRA" else got[k]) == v, k
    jmodel = get_model_builder(name)(jcfg, use_pallas=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 256, 192, 3), np.float32),
        np.zeros((1, 2, 256, 192, 1), np.float32), np.ones((1, 2), bool), train=False))
    sd = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
                         name)
    port = build_model(cfg, device="cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape)
                                                          for k, v in port.items()}
    model = build_model(cfg, device="cpu")
    assert model.feat_hw == (64, 48) and (model.single_steps, model.pool_steps) == (0, 2)
    assert len(model.single_global_encoder.layers) == 4
    assert len(model.multi_global_encoder.layers) == 2


def test_validate_and_serving_match_jax(tmp_path):
    """The tiny ``interformer_e2e_new`` on the fixture's val2017: the port's
    ``validate`` against the JAX ``validate`` on the same weights (AP within
    1e-6), and ``Predictor`` serving it: finite keypoints of the right
    shapes, the same requests at buckets 2/4 and at bucket 4 alone within
    1e-4."""
    name = "interformer_e2e_new"
    changes = {"DATASET.DATASET": "coco", "DATASET.ROOT": str(FIXTURE),
               "DATASET.TEST_SET": "val2017", "DATASET.MAX_PATCH": 7,
               "TEST.BATCH_SIZE_PER_GPU": 8, "TEST.BLUR_KERNEL": 5, "MODEL.NUM_JOINTS": 17}
    jcfg, jmodel, variables, model = models(name, **changes)
    jds = JaxCOCO(jcfg, str(FIXTURE), "val2017", is_train=False)
    want, wperf = jax_validate(jcfg, jds, jmodel, variables, str(tmp_path / "jax"))
    cfg = presets.from_config(jcfg)
    ds = COCODataset(cfg, str(FIXTURE), "val2017", is_train=False)
    got, perf = validate(cfg, ds, model, str(tmp_path / "port"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)

    pred = Predictor(model, cfg, ds.flip_pairs, batch_images=2, n_buckets=(2, 4),
                     raw_hw=(480, 640))
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 255, (120, 160, 3), dtype=np.uint8) for _ in range(3)]
    boxes = [[[10, 10, 40, 80], [60, 20, 50, 90]], [[5, 5, 100, 100]],
             [[0, 0, 30, 60], [40, 10, 30, 60], [80, 10, 30, 60]]]
    out = pred.predict(images, boxes)
    assert [o.shape for o in out] == [(2, 17, 3), (1, 17, 3), (3, 17, 3)]
    assert all(np.isfinite(o).all() for o in out)
    again = Predictor(model, cfg, ds.flip_pairs, batch_images=2, n_buckets=(4,),
                      raw_hw=(480, 640)).predict(images, boxes)
    for a, b in zip(out, again):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
