"""The TransPose-H I²R-Net port (``models/transpose_h.py``, the two-stage
``models/interformer.py`` with that first stage) vs the JAX package, on the
CPU, float32, weights carried by ``params_from_jax``.

The JAX model runs with ``use_pallas=True``, its Kernels A and B in Pallas's
interpret mode, as its own tests run it on the CPU; the port's kernel routes
are on, and on CPU tensors they take the plain versions (no launch counted).
Inputs come from numpy seeds; both sides get the same arrays.

Tolerance: atol 1e-5 / rtol 1e-4 (two frameworks' f32 conv and matmul
orders), as ``tests/test_torch_pure_multi.py``. Padded persons' heatmaps are
exactly 0 on both sides. The round trip through the JAX package's
``convert_state_dict`` is bit for bit.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from i2rnet_tpu.config import load_config
from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.core.validate import validate as jax_validate
from i2rnet_tpu.data.coco import COCODataset as JaxCOCO
from i2rnet_tpu.models.position import sine_position_embedding_2d as jax_sine
from i2rnet_tpu.presets import tiny_test_config
from i2rnet_tpu.registry import get_model_builder
from i2rnet_tpu.serving import make_serve_fn as jax_make_serve_fn
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.models.interformer import InterFormer, build_model
from i2rnet_tpu_torch.models.position import sine_position_embedding_2d
from i2rnet_tpu_torch.models.pure_multi import PureMultiInterFormer
from i2rnet_tpu_torch.models.transpose_h import TransPoseH
from i2rnet_tpu_torch.ops.cuda import KERNELS, launch_counts, reset_launches
from i2rnet_tpu_torch.serving import Predictor
from test_torch_bridge import random_variables

import torch_fixture

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TPH_YAML = REPO / "experiments" / "coco" / "interformer_coco_tph_192_p4_b4.yaml"
ATOL, RTOL = 1e-5, 1e-4
T = torch.from_numpy
#: the JAX tiny model's keys that the port's tiny TPH config mirrors
TINY_TPH = {"NAME": "interformer_2stage", "SINGLEFORMER": "transpose_h", "ENCODER_LAYERS": 1,
            "ENCODER_MULTI_LAYERS": 1, "UPSAMPLE_TYPE": "multiplex", "USE_MULTI_POS": True,
            "MULTI_POS_EMBEDDING": "conv", "MULTI_POS_EMBEDDING_DIM": 8,
            "POS_EMBEDDING": "sine", "HRNET_RES_LAYER": 0}


def jax_cfg(num_joints=5, **model):
    """The JAX tiny config (``tests/test_interformer.py::tiny_interformer_cfg``)
    in the recipe's composition, with ``model`` overrides; Pallas on."""
    cfg = tiny_test_config(num_joints).clone()
    for k, v in {**TINY_TPH, **model}.items():
        setattr(cfg.MODEL, k, v)
    cfg.TPU.USE_PALLAS_ATTENTION = True
    return cfg


def jax_model(cfg):
    return get_model_builder(cfg.MODEL.NAME)(cfg, use_pallas=True)


def port(cfg, variables):
    """The port's model of the JAX ``cfg`` (``from_config``), kernel routes on,
    with the JAX weights."""
    model = build_model(presets.from_config(cfg), use_kernels=True, device="cpu")
    model.load_state_dict(params_from_jax(variables, cfg.MODEL.NAME), strict=True)
    return model


def inputs(rng, valid, h=64, w=48):
    b, n = valid.shape
    images = rng.randn(b, n, h, w, 3).astype(np.float32)
    pos = np.zeros((b, n, h, w, 1), np.float32)
    for i in range(b):
        for j in range(n):
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            pos[i, j, y0:y0 + h // 2, x0:x0 + w // 2] = 1.0
    return images, pos, valid


RAGGED = np.array([[1, 1, 1], [1, 0, 0]], bool)


def test_sine_position_embedding_is_the_jax_table():
    for h, w, d in ((64, 48, 96), (16, 12, 16), (5, 7, 12)):
        got = sine_position_embedding_2d(h, w, d)
        assert got.dtype == np.float32 and got.shape == (h * w, d)
        np.testing.assert_array_equal(got, jax_sine(h, w, d))


@pytest.mark.parametrize("pos_embedding", ["sine", "learnable"])
def test_transpose_h_matches_jax(rng, pos_embedding):
    """The first stage alone: features [P, 16, 16, 12] and heatmaps."""
    cfg = jax_cfg(POS_EMBEDDING=pos_embedding)
    jm = get_model_builder("transpose_h")(cfg, use_pallas=True)
    x = rng.randn(3, 64, 48, 3).astype(np.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x, None, train=False))
    full = random_variables(jax_model(cfg), cfg, seed=1)  # the same leaves, under singleformer/
    variables = {k: full[k]["singleformer"] for k in ("params", "batch_stats")}
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda s: 0, shapes))
    feat_ref, heat_ref = map(np.asarray, jax.jit(lambda a: jm.apply(variables, a))(x))
    sd = {k[len("singleformer."):]: v for k, v in params_from_jax(full, cfg.MODEL.NAME).items()
          if k.startswith("singleformer.")}
    m = presets.from_config(cfg)["MODEL"]
    tph = TransPoseH(m["EXTRA"], 5, 16, 32, 2, 1, (48, 64), pos_embedding)
    tph.load_state_dict(sd, strict=True)
    tph.global_encoder.use_kernels = True
    reset_launches()
    with torch.no_grad():
        feat, heat = tph.eval()(T(x).permute(0, 3, 1, 2))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)
    assert tuple(feat.shape) == (3, 16, 16, 12) and heat.dtype == torch.float32
    assert np.abs(heat_ref).max() > 0.05
    np.testing.assert_allclose(feat.permute(0, 2, 3, 1).numpy(), feat_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(heat.numpy(), heat_ref, rtol=RTOL, atol=ATOL)


#: (name, upsample, multi-pos mode or None, DOMAIN_TRANS): the recipe's
#: composition first, then each upsampling, position mode and the 1x1 pair
VARIANTS = [("interformer_2stage", "multiplex", "conv", False),
            ("interformer", "deconv", None, False),
            ("interformer_2stage", "upconv", "res", False),
            ("interformer", "multiplex", "res", True),
            ("interformer_2stage", "deconv", "conv", True)]


def variant_cfg(name, upsample, mode, domain_trans):
    return jax_cfg(NAME=name, UPSAMPLE_TYPE=upsample, USE_MULTI_POS=mode is not None,
                   MULTI_POS_EMBEDDING=mode or "conv", DOMAIN_TRANS=domain_trans)


@pytest.mark.parametrize("variant", VARIANTS, ids=["-".join(map(str, v)) for v in VARIANTS])
def test_interformer_matches_jax(rng, variant):
    """B=2, N=3 with 3 and 1 valid persons: ``multi`` and ``single``."""
    cfg = variant_cfg(*variant)
    jm = jax_model(cfg)
    variables = random_variables(jm, cfg, seed=2)
    args = inputs(rng, RAGGED)
    ref = jax.jit(lambda *a: jm.apply(variables, *a, train=False))(*args)
    model = port(cfg, variables)
    assert isinstance(model, InterFormer) and isinstance(model.singleformer, TransPoseH)
    reset_launches()
    with torch.no_grad():
        got = model(*map(T, args))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # CPU tensors: the plain versions
    for key in ("multi", "single"):
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert g.shape == (2, 3, 5, 16, 12) and g.dtype == np.float32
        assert np.isfinite(g).all() and np.abs(r).max() > 0.05
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL, err_msg=key)
        assert not g[~RAGGED].any() and not r[~RAGGED].any()


#: the variants whose every name the JAX converter maps: not ``upconv`` (no
#: rule for its names), ``domain_trans_*`` under ``interformer_2stage`` only;
#: ``params_from_jax`` alone carries those, into the strict loads above
ROUND_TRIPS = [("interformer_2stage", "multiplex", "conv", False),
               ("interformer", "deconv", None, False),
               ("interformer", "multiplex", "res", False),
               ("interformer_2stage", "deconv", "conv", True)]


@pytest.mark.parametrize("variant", ROUND_TRIPS, ids=["-".join(map(str, v)) for v in ROUND_TRIPS])
def test_round_trip_is_exact(variant):
    """The JAX tree through ``params_from_jax`` and the JAX package's
    ``convert_state_dict`` back: bit for bit, every name matched, the port's
    state dict exactly the model's."""
    name = variant[0]
    cfg = variant_cfg(*variant)
    variables = random_variables(jax_model(cfg), cfg, seed=5)
    sd = {k: v.numpy() for k, v in params_from_jax(variables, name).items()}
    back, unmatched = convert_state_dict(sd, name, strict=True)
    assert unmatched == []
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (path, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    own = build_model(presets.from_config(cfg), device="cpu").state_dict()
    assert set(sd) == set(own)
    assert {k: v.shape for k, v in sd.items()} == {k: tuple(v.shape) for k, v in own.items()}


def test_from_config_of_the_recipe_is_the_preset():
    """``from_config(load_config(<COCO TPH YAML>))`` equals
    ``presets.tph_interformer()`` on every key the port's preset holds; the
    tiny preset is the JAX tiny config's likewise (kernel routes off, as the
    JAX tiny config)."""
    tiny = jax_cfg()
    tiny.TPU.USE_PALLAS_ATTENTION = False
    for jcfg, want in ((load_config(str(TPH_YAML)), presets.tph_interformer()),
                       (tiny, presets.tiny_tph_config(5))):
        got = presets.from_config(jcfg)
        for sec in ("MODEL", "TEST", "DEVICE", "DATASET", "TRAIN", "LOSS"):
            for k, v in want[sec].items():
                if k == "EXTRA":
                    for ek, ev in v.items():
                        assert got[sec][k][ek] == ev, (sec, k, ek)
                else:
                    assert got[sec][k] == v, (sec, k, got[sec][k], v)
    m = presets.tph_interformer()["MODEL"]
    assert (m["ENCODER_MULTI_LAYERS"], m["UPSAMPLE_TYPE"], m["NAME"]) == (4, "multiplex",
                                                                          "interformer_2stage")


def test_build_model_dispatches_on_the_name_and_first_stage():
    model = build_model(presets.tiny_tph_config(5), device="cpu")
    assert isinstance(model, InterFormer) and not model.training
    assert isinstance(model.singleformer, TransPoseH)
    assert [len(e.layers) for e in model.encoders()] == [1, 1]
    assert tuple(model.singleformer.pos_embedding.shape) == (16 * 12, 16)
    assert not any("pos_embedding" in k for k in model.state_dict())  # the fixed sine table
    full = build_model(presets.tph_interformer(), use_kernels=True, device="cpu")
    assert [len(e.layers) for e in full.encoders()] == [6, 4]
    assert all(e.use_kernels for e in full.encoders())
    assert full.compute_dtype == torch.bfloat16
    assert isinstance(build_model(presets.tiny_test_config(5), device="cpu"),
                      PureMultiInterFormer)
    for key, value, err in (("SINGLEFORMER", "hrnet", NotImplementedError),
                            ("ATTENTION_TYPE", "window", NotImplementedError),
                            ("UPSAMPLE_TYPE", "bilinear", ValueError),
                            ("POS_EMBEDDING", "bogus", ValueError),
                            ("POS_EMBEDDING", "none", NotImplementedError),
                            ("PE_ONLY_AT_BEGIN", True, NotImplementedError)):
        cfg = presets.tiny_tph_config(5)
        cfg["MODEL"][key] = value
        with pytest.raises(err, match=key if key != "SINGLEFORMER" else "SINGLEFORMER"):
            build_model(cfg, device="cpu")
    for mode in ("sine", "cat_vec"):
        cfg = presets.tiny_tph_config(5)
        cfg["MODEL"]["MULTI_POS_EMBEDDING"] = mode
        with pytest.raises(NotImplementedError, match=mode):
            build_model(cfg, device="cpu")


def test_training_forward_raises():
    """A TPH model trains (``tests/test_torch_transpose_h_train.py``), with
    ``DEVICE.REMAT`` layers too: both encoders' layers are recomputed, the
    training forward as without it (``tests/test_torch_remat.py`` holds the
    step); an eval forward runs. A frozen first stage
    (``SINGLEFORMER_FIX``; with ``FROZEN_STAGE_EVAL_MODE`` in eval mode, its
    BatchNorm statistics kept) trains the rest: no ``single`` heatmaps, no
    gradient into the first stage (held against JAX in
    ``tests/test_torch_pretrained.py``)."""
    z = torch.zeros(1, 2, 64, 48, 3)
    args = (z, z[..., :1], torch.ones(1, 2, dtype=torch.bool))
    cfg = presets.tiny_tph_config(5)
    cfg["DEVICE"]["REMAT"] = "layers"
    model = build_model(cfg, device="cpu")
    plain = build_model(presets.tiny_tph_config(5), device="cpu")
    plain.load_state_dict(model.state_dict())
    assert [e.remat for e in model.encoders()] == [True, True]
    out = model(*args, train=True, dropout_seed=0)
    assert torch.equal(out["multi"], plain(*args, train=True, dropout_seed=0)["multi"])
    out["multi"].sum().backward()
    assert all(p.grad is not None for p in model.singleformer.global_encoder.parameters())
    with torch.no_grad():
        assert model.eval()(*args)["multi"].shape == (1, 2, 5, 16, 12)
    for eval_mode in (False, True):
        cfg = presets.tiny_tph_config(5)
        cfg["MODEL"]["SINGLEFORMER_FIX"] = True
        cfg["DEVICE"]["FROZEN_STAGE_EVAL_MODE"] = eval_mode
        model = build_model(cfg, device="cpu")
        stats = {k: v.clone() for k, v in model.singleformer.state_dict().items()
                 if "running" in k}
        out = model.train()(*args, train=True, dropout_seed=0)
        out["multi"].sum().backward()
        assert out["single"] is None and model.singleformer.training
        assert all(p.grad is None for p in model.singleformer.parameters())
        assert any(p.grad is not None for p in model.multi_global_encoder.parameters())
        kept = all(torch.equal(v, model.singleformer.state_dict()[k]) for k, v in stats.items())
        assert kept == eval_mode


FLIP_PAIRS = [[1, 2], [3, 4]]


def test_predictor_serves_the_tph_model_as_jax(rng):
    """The TPH model behind ``Predictor``: every static call it makes, fed to
    the jitted JAX serve function of the same weights (Pallas in interpret
    mode), gives the same keypoints (argmax decode: 1e-3 px; confidences
    atol 1e-5 / rtol 1e-4)."""
    cfg = jax_cfg()
    cfg.TEST.POST_PROCESS = False
    jm = jax_model(cfg)
    variables = random_variables(jm, cfg, seed=6)
    jserve = jax.jit(lambda *a: jax_make_serve_fn(cfg, jm, FLIP_PAIRS)(variables, *a))
    pred = Predictor(port(cfg, variables), presets.from_config(cfg), FLIP_PAIRS,
                     batch_images=2, n_buckets=(2, 3), raw_hw=(96, 128))
    calls, serve = [], pred.serve

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


def spy_preds(ds):
    """Record the predictions and boxes ``validate`` hands to ``ds.evaluate``."""
    seen, evaluate = [], ds.evaluate

    def spy(cfg, preds, output_dir, all_boxes, image_ids):
        seen.append((np.array(preds), np.array(all_boxes), list(image_ids)))
        return evaluate(cfg, preds, output_dir, all_boxes, image_ids)

    ds.evaluate = spy
    return seen


def test_validate_on_the_fixture_matches_jax(tmp_path):
    """``validate`` with the tiny TPH model (17 joints) on the committed
    COCO-format fixture against the JAX ``validate`` of the same weights,
    argmax decode, B=16: the same persons and boxes in the same order,
    keypoints within 1e-3 px, confidences within atol 1e-5 / rtol 1e-4, AP
    equal."""
    fx = str(torch_fixture.FIXTURE)
    cfg = jax_cfg(17)
    cfg.DATASET.DATASET = "coco"
    cfg.DATASET.ROOT = fx
    cfg.DATASET.TEST_SET = "val2017"
    cfg.TEST.POST_PROCESS = False
    cfg.TEST.BATCH_SIZE_PER_GPU = torch_fixture.BATCH
    cfg.WORKERS = 2
    jm = jax_model(cfg)
    variables = random_variables(jm, cfg, seed=7)
    jds = JaxCOCO(cfg, fx, "val2017", is_train=False)
    tcfg = presets.from_config(cfg)
    tds = COCODataset(tcfg, fx, "val2017", is_train=False)
    jseen, tseen = spy_preds(jds), spy_preds(tds)
    want, _ = jax_validate(cfg, jds, jm, variables, str(tmp_path / "jax"))
    got, _ = validate(tcfg, tds, port(cfg, variables), str(tmp_path / "port"))
    (tp, tb, ti), (jp, jb, ji) = tseen[0], jseen[0]
    assert len(tp) == 134 and ti == ji
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_allclose(tp[..., :2], jp[..., :2], atol=1e-3, rtol=0)
    np.testing.assert_allclose(tp[..., 2], jp[..., 2], atol=1e-5, rtol=1e-4)
    assert np.abs(jp[..., 2]).max() > 0.05
    assert got["AP"] == want["AP"]
