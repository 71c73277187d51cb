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
    model = build_pure_multi(presets.from_config(cfg), use_kernels=use_kernels)
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
    model = build_pure_multi(presets.from_config(cfg))
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
    port = build_pure_multi(presets.from_config(cfg)).state_dict()
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
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")
    assert len(mods) >= 30
    assert {"i2rnet_tpu_torch.core.trainer", "i2rnet_tpu_torch.ops.cuda.mhsa_train",
            "i2rnet_tpu_torch.ops.cuda.encoder_ffn_train", "i2rnet_tpu_torch.utils.checkpoint",
            "i2rnet_tpu_torch.data.synthetic"} <= set(mods)


def test_from_config_matches_presets():
    from i2rnet_tpu.presets import w48_pure_en6

    for jax_cfg, port_cfg in ((tiny_test_config(5), presets.tiny_test_config(5)),
                              (w48_pure_en6(), presets.w48_pure_en6())):
        got = presets.from_config(jax_cfg)
        for sec in ("MODEL", "TEST", "DEVICE", "DATASET", "TRAIN", "LOSS"):
            for k, v in port_cfg[sec].items():
                if k == "EXTRA":
                    for ek, ev in v.items():
                        assert got[sec][k][ek] == ev, (sec, k, ek)
                else:
                    assert got[sec][k] == v, (sec, k)
        for k in ("SEED", "AUTO_RESUME", "PRINT_FREQ"):
            assert got[k] == port_cfg[k], k


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
