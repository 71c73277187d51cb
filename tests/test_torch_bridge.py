"""The port's weight bridge, import guard and copied host helpers.

* ``params_from_jax`` is the exact inverse of the JAX package's
  ``convert_state_dict``: a round trip returns the variable tree bit for bit.
* Every module of ``i2rnet_tpu_torch``, and ``chip_smoke.py``, imports with
  ``jax``, ``flax``, ``yaml``, ``cv2`` and ``i2rnet_tpu`` blocked: the port
  runs where none of the first four is installed, and uses nothing of the last.
* The host helpers the port copies equal the JAX package's.

``tiny_jax_model`` and ``random_variables`` are shared with the other
``test_torch_*`` files: seeded numpy weights at a scale that keeps the
activations O(1) (the JAX initialisers' 0.001-std convs would make every
comparison one of near-zero tensors).
"""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.presets import tiny_test_config
from i2rnet_tpu.registry import get_model_builder
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import build_pure_multi

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def tiny_jax_model(use_pallas=True, num_joints=5):
    cfg = tiny_test_config(num_joints)
    return cfg, get_model_builder(cfg.MODEL.NAME)(cfg, use_pallas=use_pallas)


def random_variables(model, cfg, seed=0):
    """Seeded numpy values for every leaf of ``model``'s variable tree."""
    iw, ih = cfg.MODEL.IMAGE_SIZE
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), np.zeros((1, 2, ih, iw, 3), np.float32),
        np.zeros((1, 2, ih, iw, 1), np.float32), np.ones((1, 2), bool), train=False))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def port_model(variables, cfg, use_kernels=False):
    model = build_pure_multi(presets.from_config(cfg), use_kernels=use_kernels, device="cpu")
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


@pytest.fixture(scope="module")
def jax_tiny():
    cfg, model = tiny_jax_model()
    return cfg, model, random_variables(model, cfg)


def test_round_trip_is_exact(jax_tiny):
    cfg, _, variables = jax_tiny
    sd = {k: v.numpy() for k, v in params_from_jax(variables).items()}
    back, unmatched = convert_state_dict(sd, "interformer_pureMulti", strict=True)
    assert unmatched == []
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (path, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))


def test_state_dict_names_cover_the_port(jax_tiny):
    """strict load: the bridge names every port parameter and buffer, and
    every name it makes exists in the port."""
    cfg, _, variables = jax_tiny
    model = build_pure_multi(presets.from_config(cfg), device="cpu")
    assert set(params_from_jax(variables)) == set(model.state_dict())
    assert not any(k.startswith("pos_embedding") for k in model.state_dict())


def test_bridge_covers_the_full_width_model():
    """W48-pure-en6 at full width (shapes only): every JAX leaf maps to a port
    tensor of the same name set and shape."""
    from i2rnet_tpu.presets import w48_pure_en6

    cfg = w48_pure_en6()
    jmodel = get_model_builder(cfg.MODEL.NAME)(cfg, use_pallas=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 2, 256, 192, 3), np.float32),
        np.zeros((1, 2, 256, 192, 1), np.float32), np.ones((1, 2), bool), train=False))
    sd = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes))
    port = build_pure_multi(presets.from_config(cfg), device="cpu").state_dict()
    assert set(sd) == set(port)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in port.items()}


def test_port_imports_without_jax_yaml_cv2():
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "i2rnet_tpu_torch").rglob("*.py")) + ["chip_smoke"]
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'yaml', 'cv2', 'i2rnet_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"import importlib\nfor m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith(('jax.', 'i2rnet_tpu.'))\n"
            "               for k, v in sys.modules.items() if v is not None)\n"
            "from i2rnet_tpu_torch import native\n"
            "assert native.box_nms([[0, 0, 9, 9, 0.9], [1, 1, 9, 9, 0.8]], 0.5) == [0]\n"
            "import tempfile\n"
            "from i2rnet_tpu_torch.data import synthetic as s\n"
            "with tempfile.TemporaryDirectory() as d:\n"
            "    s.make_synthetic_detections(s.make_synthetic_coco(d, num_images=1))\n"
            "    s.make_synthetic_crowdpose(d + '/c', num_images=1)\n"
            "    s.make_synthetic_ochuman(d + '/o', num_images=1)\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert len(mods) >= 30
    assert {"i2rnet_tpu_torch.core.trainer", "i2rnet_tpu_torch.ops.cuda.mhsa_train",
            "i2rnet_tpu_torch.ops.cuda.encoder_ffn_train", "i2rnet_tpu_torch.utils.checkpoint",
            "i2rnet_tpu_torch.data.synthetic", "i2rnet_tpu_torch.models.hrformer",
            "i2rnet_tpu_torch.models.interformer", "i2rnet_tpu_torch.ops.cuda.hrformer_block",
            "i2rnet_tpu_torch.ops.cuda.mlp_dwbn",
            "i2rnet_tpu_torch.ops.cuda.hrformer_block_train", "i2rnet_tpu_torch.core.validate",
            "i2rnet_tpu_torch.data.coco", "i2rnet_tpu_torch.data.dataset",
            "i2rnet_tpu_torch.data.coco_format", "i2rnet_tpu_torch.data.jpeg",
            "i2rnet_tpu_torch.data.resize", "i2rnet_tpu_torch.data.prefetch",
            "i2rnet_tpu_torch.ops.cocoeval", "i2rnet_tpu_torch.ops.nms",
            "i2rnet_tpu_torch.registry", "i2rnet_tpu_torch.data.crowdpose",
            "i2rnet_tpu_torch.data.ochuman", "i2rnet_tpu_torch.data.train_record",
            "i2rnet_tpu_torch.config.yaml_lite", "i2rnet_tpu_torch.config.config",
            "i2rnet_tpu_torch.core.pretrained", "i2rnet_tpu_torch.utils.logging",
            "i2rnet_tpu_torch.tools.train", "i2rnet_tpu_torch.tools.test",
            "i2rnet_tpu_torch.data.mpii", "i2rnet_tpu_torch.probes.recipes_probe",
            "i2rnet_tpu_torch.hub", "i2rnet_tpu_torch.tools.export",
            "i2rnet_tpu_torch.tools.demo", "i2rnet_tpu_torch.utils.vis",
            "i2rnet_tpu_torch.ops.cuda.library", "i2rnet_tpu_torch.serving",
            "i2rnet_tpu_torch.utils.detail_eval", "i2rnet_tpu_torch.tools.visualize",
            "i2rnet_tpu_torch.tools.compute_flops", "i2rnet_tpu_torch.tools.profile",
            "i2rnet_tpu_torch.tools.confirm_eval", "i2rnet_tpu_torch.tools.trans_json",
            "i2rnet_tpu_torch.tools.vis_demo", "i2rnet_tpu_torch.tools.reproduce",
            "i2rnet_tpu_torch.parallel.dist", "i2rnet_tpu_torch.models.interformer_e2e",
            "i2rnet_tpu_torch.probes.ddp_rank", "i2rnet_tpu_torch.native",
            "i2rnet_tpu_torch.models.position", "i2rnet_tpu_torch.models.encoder",
            "i2rnet_tpu_torch.models.layers", "i2rnet_tpu_torch.models.transpose_h",
            "i2rnet_tpu_torch.models.pure_multi", "i2rnet_tpu_torch.convert.jax_import",
            "i2rnet_tpu_torch.ops.cuda.mhsa", "i2rnet_tpu_torch.ops.cuda.encoder_ffn"} <= set(mods)


def with_recipe_data(jax_cfg):
    """A JAX preset with its recipe's data location: the JAX presets leave
    ``ROOT``, ``TRAIN_SET``, ``TEST_SET`` and ``COCO_BBOX_FILE`` at the
    config defaults, the port's take the recipe's (held against the YAML by
    ``test_presets_take_their_recipes_data_and_test_keys``)."""
    cfg = jax_cfg.clone()
    for k, v in presets.COCO_RECIPE_DATA.items():
        setattr(cfg.DATASET, k, v)
    cfg.TEST.COCO_BBOX_FILE = presets.COCO_RECIPE_BBOX_FILE
    return cfg


def test_from_config_matches_presets():
    from i2rnet_tpu.presets import w48_pure_en6

    for jax_cfg, port_cfg in ((tiny_test_config(5), presets.tiny_test_config(5)),
                              (with_recipe_data(w48_pure_en6()), presets.w48_pure_en6())):
        got = presets.from_config(jax_cfg)
        for sec in ("MODEL", "TEST", "DEVICE", "DATASET", "TRAIN", "LOSS"):
            for k, v in port_cfg[sec].items():
                if k == "EXTRA":
                    for ek, ev in v.items():
                        assert got[sec][k][ek] == ev, (sec, k, ek)
                else:
                    assert got[sec][k] == v, (sec, k)
        for k in ("SEED", "AUTO_RESUME", "PRINT_FREQ", "WORKERS"):
            assert got[k] == port_cfg[k], k
        for k, v in port_cfg["DEBUG"].items():  # the presets set DEBUG.DEBUG only
            assert got["DEBUG"][k] == v, k
        assert not any(got["DEBUG"].values())


@pytest.mark.parametrize("preset,recipe", [
    (presets.w48_pure_en6, "interformer_coco_w48_pure_en6.yaml"),
    (presets.hrt_interformer, "interformer_coco_hrt_192_p2_b12.yaml")])
def test_presets_take_their_recipes_data_and_test_keys(preset, recipe):
    """Every ``DATASET`` and ``TEST`` key of the port's preset, and
    ``WORKERS``, as the recipe sets it."""
    import yaml

    want = yaml.safe_load((REPO / "experiments" / "coco" / recipe).read_text())
    got = preset()
    for sec in ("DATASET", "TEST"):
        for k, v in got[sec].items():
            assert want[sec][k] == v, (sec, k)
    assert got["WORKERS"] == want["WORKERS"]


def test_host_helpers_match():
    from i2rnet_tpu.data.coco import COCODataset
    from i2rnet_tpu.ops import decode as jdecode
    from i2rnet_tpu.ops.preprocess import np_rotate_bound_resize_affine as j_rot
    from i2rnet_tpu.ops.transforms import np_get_affine_transform as j_aff
    from i2rnet_tpu.serving import boxes_to_person_meta as j_meta
    from i2rnet_tpu_torch.ops import decode as tdecode
    from i2rnet_tpu_torch.ops.preprocess import np_rotate_bound_resize_affine as t_rot
    from i2rnet_tpu_torch.ops.transforms import np_get_affine_transform as t_aff
    from i2rnet_tpu_torch.serving import boxes_to_person_meta as t_meta

    rng = np.random.RandomState(3)
    for _ in range(5):
        c, s, rot = rng.uniform(10, 400, 2), rng.uniform(0.2, 3, 2), rng.uniform(-45, 45)
        for inv in (False, True):
            np.testing.assert_array_equal(t_aff(c, s, rot, (192, 256), inv=inv),
                                          j_aff(c, s, rot, (192, 256), inv=inv))
        args = (int(rng.randint(50, 900)), int(rng.randint(50, 900)), float(rot), 192, 256)
        np.testing.assert_array_equal(t_rot(*args), j_rot(*args))
    boxes = [[3.5, 7.0, 40.0, 90.0], [100.0, 20.0, 120.0, 60.0], [0.0, 0.0, 13.0, 13.0]]
    for a, b in zip(t_meta(boxes, (192, 256)), j_meta(boxes, (192, 256))):
        np.testing.assert_array_equal(a, b)
    for k in (3, 5, 7, 11):
        np.testing.assert_allclose(tdecode.gaussian_kernel1d(k),
                                   jdecode._cv2_gaussian_kernel1d(k), rtol=1e-6, atol=1e-8)
    assert presets.COCO_FLIP_PAIRS == COCODataset.flip_pairs


def test_interformer_round_trip_is_exact():
    """The HRFormer two-stage model's tree (tiny HRFormer) through
    ``params_from_jax`` and back: bit for bit, every name matched."""
    from test_torch_hrformer import _person_inputs, init, jax_interformer

    args = _person_inputs(np.random.RandomState(0), np.ones((1, 2), bool))
    variables = init(jax_interformer("off"), *args, train=False, seed=5)
    sd = {k: v.numpy() for k, v in params_from_jax(variables, "interformer").items()}
    back, unmatched = convert_state_dict(sd, "interformer", strict=True)
    assert unmatched == []
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (path, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    port = build_model(presets.tiny_hrt_config(5), device="cpu").state_dict()
    assert set(sd) == set(port)
    assert any(k.endswith("relative_position_index") for k in sd)


def test_bridge_covers_the_full_width_hrt_model():
    """HRFormer-B I²R-Net at 256x192 (shapes only): every JAX leaf maps to a
    port tensor of the same name set and shape."""
    from i2rnet_tpu.presets import hrt_interformer

    cfg = hrt_interformer()
    jmodel = get_model_builder(cfg.MODEL.NAME)(cfg, use_pallas=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 1, 256, 192, 3), np.float32),
        np.zeros((1, 1, 256, 192, 1), np.float32), np.ones((1, 1), bool), train=False))
    sd = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
                         "interformer")
    port = build_model(presets.from_config(cfg), device="cpu").state_dict()
    assert set(sd) == set(port)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in port.items()}
    assert sum(k.endswith("attn.attn.q_proj.weight") for k in sd) == 44  # transformer blocks


def test_from_config_matches_the_hrt_preset():
    """Equal key for key (the data location as in the recipe), but
    ``DEVICE.FUSED_BLOCK_TRAIN``: the port's preset turns on the kernel
    route the JAX recipe leaves off (``presets.hrt_interformer``), and
    ``from_config`` carries the JAX value; and ``TEST.BATCH_SIZE_PER_GPU``,
    which the port's preset takes from the recipe."""
    from i2rnet_tpu.presets import hrt_interformer

    got = presets.from_config(with_recipe_data(hrt_interformer()))
    want = presets.hrt_interformer()
    for sec in ("MODEL", "TEST", "DEVICE", "DATASET"):
        for k, v in want[sec].items():
            if (sec, k) not in (("DEVICE", "FUSED_BLOCK_TRAIN"), ("TEST", "BATCH_SIZE_PER_GPU")):
                assert got[sec][k] == v, (sec, k)
    assert want["DEVICE"]["FUSED_BLOCK_TRAIN"] and not got["DEVICE"]["FUSED_BLOCK_TRAIN"]
    # the recipe's eval batch; the JAX preset keeps 32
    assert (want["TEST"]["BATCH_SIZE_PER_GPU"], got["TEST"]["BATCH_SIZE_PER_GPU"]) == (64, 32)
    jcfg = hrt_interformer()
    jcfg.TPU.FUSED_BLOCK_TRAIN = True
    assert presets.from_config(jcfg)["DEVICE"]["FUSED_BLOCK_TRAIN"] is True


@pytest.mark.parametrize("onepass", [False, True])
def test_from_config_carries_the_onepass_knob(onepass):
    """``TPU.FUSED_BLOCK_EVAL_ONEPASS`` reaches ``DEVICE`` and, through
    ``build_model``, every HRFormer block's kernel-7 route."""
    from i2rnet_tpu.presets import hrt_interformer

    jcfg = hrt_interformer()
    jcfg.TPU.FUSED_BLOCK_EVAL_ONEPASS = onepass
    cfg = presets.from_config(jcfg)
    assert cfg["DEVICE"]["FUSED_BLOCK_EVAL_ONEPASS"] is onepass
    tiny = presets.tiny_hrt_config(5)
    tiny["DEVICE"].update(USE_KERNELS=True, FUSED_BLOCK_EVAL_ONEPASS=onepass)
    blocks = build_model(tiny, device="cpu").singleformer.blocks()
    routes = {(b.use_kernels, b.fused_block, b.fused_onepass) for b in blocks}
    assert routes == {(True, True, onepass)}


def test_builders_default_to_the_card():
    """Without a ``device`` the builders put the model on CUDA: on a host
    without it they raise, and hand back no CPU model."""
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    for cfg in (presets.tiny_test_config(5), presets.tiny_hrt_config(5)):
        with pytest.raises((RuntimeError, AssertionError)):
            build_model(cfg)
    with pytest.raises((RuntimeError, AssertionError)):
        build_pure_multi(presets.tiny_test_config(5))


@pytest.mark.parametrize("remat", [True, "layers", "dots"])
def test_remat_refuses_a_training_forward(remat):
    """``DEVICE.REMAT`` reaches both models through ``from_config``: the eval
    and the training forward run as without it (``tests/test_torch_remat.py``
    holds whole steps); ``layers`` (or True) sets each encoder layer and
    HRFormer block to be recomputed, ``dots`` leaves the model as it is (the
    step recomputes). An unknown value is refused at build time."""
    from i2rnet_tpu.presets import hrt_interformer

    jcfg = tiny_test_config(5)
    jcfg.TPU.REMAT = remat
    cfg = presets.from_config(jcfg)
    assert cfg["DEVICE"]["REMAT"] == remat
    layers = remat in (True, "layers")
    model = build_pure_multi(cfg, device="cpu")
    plain = build_pure_multi(presets.tiny_test_config(5), device="cpu")
    plain.load_state_dict(model.state_dict())
    assert model.global_encoder.remat is layers and plain.global_encoder.remat is False
    images = torch.rand(1, 2, 64, 48, 3, generator=torch.Generator().manual_seed(0))
    pos = torch.zeros(1, 2, 64, 48, 1)
    valid = torch.tensor([[True, False]])
    with torch.no_grad():
        assert model(images, pos, valid).shape == (1, 2, 5, 16, 12)
    out = model(images, pos, valid, train=True, dropout_seed=0)
    assert torch.equal(out, plain(images, pos, valid, train=True, dropout_seed=0))
    hrt = presets.tiny_hrt_config(5)
    hrt["DEVICE"]["REMAT"] = remat
    built = build_model(hrt, device="cpu")
    assert all(blk.remat is layers for blk in built.singleformer.blocks())
    assert built.multi_global_encoder.remat is layers
    assert presets.from_config(hrt_interformer())["DEVICE"]["REMAT"] is False
    hrt["DEVICE"]["REMAT"] = "layer"
    with pytest.raises(ValueError, match="DEVICE.REMAT"):
        build_model(hrt, device="cpu")


@pytest.mark.parametrize("flash,ffn", [(True, True), (True, False), (False, True),
                                       (False, False)])
def test_from_config_routes_the_training_kernels(flash, ffn, monkeypatch):
    """``TPU.FLASH_TRAIN_ATTENTION`` and ``TPU.FUSED_FFN_TRAIN`` reach
    ``DEVICE`` and the encoders; in a training forward every layer takes
    Kernel C on ``USE_KERNELS and FLASH_TRAIN_ATTENTION`` and Kernel D on
    ``USE_KERNELS and FUSED_FFN_TRAIN`` (``i2rnet_tpu/models/encoder.py:54,
    145``), each its plain version otherwise."""
    from i2rnet_tpu_torch.models import encoder
    from i2rnet_tpu_torch.ops import attention

    calls = []

    def record(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)

        monkeypatch.setattr(module, name, wrapped)

    for name in ("masked_mhsa_train_fused", "masked_mhsa_train_torch"):
        record(attention, name)
    for name in ("encoder_ffn_train_fused", "encoder_ffn_train_torch"):
        record(encoder, name)
    jcfg = tiny_test_config(5)
    jcfg.TPU.USE_PALLAS_ATTENTION = True
    jcfg.TPU.FLASH_TRAIN_ATTENTION = flash
    jcfg.TPU.FUSED_FFN_TRAIN = ffn
    cfg = presets.from_config(jcfg)
    assert (cfg["DEVICE"]["FLASH_TRAIN_ATTENTION"], cfg["DEVICE"]["FUSED_FFN_TRAIN"]) == (flash, ffn)
    model = build_pure_multi(cfg, device="cpu")
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randn(1, 2, 64, 48, 3).astype(np.float32))
    pos = torch.zeros(1, 2, 64, 48, 1)
    pos[..., 8:40, 8:30, :] = 1.0
    heat = model(images, pos, torch.tensor([[True, True]]), train=True, dropout_seed=3)
    assert torch.isfinite(heat).all()
    layers = len(model.global_encoder.layers)
    want = ["masked_mhsa_train_fused" if flash else "masked_mhsa_train_torch",
            "encoder_ffn_train_fused" if ffn else "encoder_ffn_train_torch"] * layers
    assert calls == want
    # with USE_KERNELS off, both plain whatever the knobs say
    calls.clear()
    model.global_encoder.use_kernels = False
    model(images, pos, torch.tensor([[True, True]]), train=True, dropout_seed=3)
    assert calls == ["masked_mhsa_train_torch", "encoder_ffn_train_torch"] * layers
    hrt = presets.tiny_hrt_config(5)
    hrt["DEVICE"].update(FLASH_TRAIN_ATTENTION=flash, FUSED_FFN_TRAIN=ffn)
    enc = build_model(hrt, device="cpu").multi_global_encoder
    assert (enc.flash_train, enc.fused_ffn_train) == (flash, ffn)


@pytest.mark.parametrize("size,recipe", [((192, 256), "interformer_coco_hrt_192_p2_b12.yaml"),
                                         ((288, 384), "interformer_coco_hrt_288_p2_b4.yaml")])
def test_hrt_preset_takes_its_recipes_training_section(size, recipe):
    """``presets.hrt_interformer`` trains with its recipe's batch and weight
    decay (12 and 0.1 at 256x192); the JAX preset keeps its own 4."""
    import yaml

    from i2rnet_tpu.presets import hrt_interformer

    want = yaml.safe_load((REPO / "experiments" / "coco" / recipe).read_text())["TRAIN"]
    got = presets.hrt_interformer(size)["TRAIN"]
    for k in ("BATCH_SIZE_PER_GPU", "WD", "LR", "END_EPOCH", "OPTIMIZER"):
        assert got[k] == want[k], k
    assert hrt_interformer().TRAIN.BATCH_SIZE_PER_GPU == 4
