"""The recipes' config tree as plain dicts, read from their YAML files.

Port of ``i2rnet_tpu/config/config.py``: :func:`default_config` is the JAX
default tree (the reference's ``lib/config/default.py`` keys and the
``TPU`` section), :func:`merge` and :func:`merge_from_list` the JAX
``Config.merge`` and ``Config.merge_from_list`` (yacs semantics: a string
over a typed default is ``ast.literal_eval``'d, lists and tuples take the
default's type, an unknown override key raises ``KeyError`` outside
``MODEL.EXTRA``), and :func:`load_config` the JAX ``load_config``: the
YAML (read by ``yaml_lite``, PyYAML's resolver included) merged over the
defaults, then the overrides, then ``OUTPUT_DIR``, ``LOG_DIR`` and
``DATA_DIR`` from the arguments and ``DATA_DIR`` joined into
``DATASET.ROOT``, ``MODEL.PRETRAINED`` and ``TEST.MODEL_FILE``. The tree is
a plain dict (``to_dict`` of the JAX ``Config`` gives the same).

:func:`to_port` makes the port config the rest of the port reads (the
shape of ``presets.py``): the ``TPU`` section becomes ``DEVICE``, and the
keys this port reads are kept. ``presets.from_config`` is ``to_port`` of a
JAX ``Config``.
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, List, Optional

from i2rnet_tpu_torch.config import yaml_lite


def default_config() -> Dict[str, Any]:
    """The JAX default tree (``i2rnet_tpu/config/config.py:132-338``)."""
    return {
        "OUTPUT_DIR": "", "LOG_DIR": "", "DATA_DIR": "", "GPUS": (0,), "WORKERS": 4,
        "PRINT_FREQ": 20, "AUTO_RESUME": False, "PIN_MEMORY": True, "RANK": 0, "SEED": 0,
        "CUDNN": {"BENCHMARK": True, "DETERMINISTIC": False, "ENABLED": True},
        "MODEL": {
            "NAME": "interformer", "SINGLEFORMER": None, "SINGLE_MODEL": "",
            "LOSS_WEIGHTS": [0.5, 0.5], "NORMALIZE_BEFORE": False, "END2END": False,
            "BACKBONE_FIX": False, "SINGLEFORMER_FIX": False, "INIT_WEIGHTS": True,
            "PRETRAINED": "", "NUM_JOINTS": 17, "TAG_PER_JOINT": True,
            "TARGET_TYPE": "gaussian", "IMAGE_SIZE": [256, 256], "HEATMAP_SIZE": [64, 64],
            "TRANS_SIZE": [16, 12], "SIGMA": 2, "HRNET_RES_LAYER": 0, "EXTRA": {},
            "BOTTLENECK_NUM": 0, "DIM_MODEL": 256, "DIM_FEEDFORWARD": 512,
            "ENCODER_LAYERS": 6, "ENCODER_MULTI_LAYERS": 4, "ENCODER_SINGLE_LAYERS": 4,
            "ENCODER_MUTI_LAYERS": 2, "USE_MULTI_POS": True, "N_HEAD": 8,
            "ATTENTION_ACTIVATION": "relu", "POS_EMBEDDING": "learnable",
            "SINGLE_POS_EMBEDDING": "sine", "INTERMEDIATE_SUP": False,
            "PE_ONLY_AT_BEGIN": False, "DOMAIN_TRANS": False, "INTER_SUPERVISION": True,
            "UPSAMPLE_TYPE": "multiplex", "MULTI_POS_EMBEDDING": "conv",
            "ATTENTION_TYPE": "default", "WINDOW_SIZE": 4, "MULTI_POS_EMBEDDING_DIM": 96,
        },
        "LOSS": {"USE_OHKM": False, "TOPK": 8, "USE_TARGET_WEIGHT": True,
                 "USE_DIFFERENT_JOINTS_WEIGHT": False},
        "DATASET": {
            "ROOT": "", "DATASET": "mpii", "TRAIN_SET": "train", "TEST_SET": "valid",
            "DATA_FORMAT": "jpg", "HYBRID_JOINTS_TYPE": "", "SELECT_DATA": False,
            "MAX_PATCH": 7, "PATCH_MODE": "random", "USE_COCOMINI": False, "FLIP": True,
            "SCALE_FACTOR": 0.25, "ROT_FACTOR": 30, "PROB_HALF_BODY": 0.0,
            "NUM_JOINTS_HALF_BODY": 8, "COLOR_RGB": False,
        },
        "TRAIN": {
            "LR_FACTOR": 0.1, "LR_STEP": [90, 110], "LR": 1e-4, "LR_END": 1e-5,
            "OPTIMIZER": "adam", "MOMENTUM": 0.9, "WD": 1e-4, "NESTEROV": False,
            "GAMMA1": 0.99, "GAMMA2": 0.0, "BEGIN_EPOCH": 0, "END_EPOCH": 140,
            "RESUME": False, "CHECKPOINT": "", "BATCH_SIZE_PER_GPU": 32, "SHUFFLE": True,
        },
        "TEST": {
            "BLUR_KERNEL": 3, "BATCH_SIZE_PER_GPU": 32, "FLIP_TEST": False,
            "POST_PROCESS": False, "SHIFT_HEATMAP": False, "USE_GT_BBOX": False,
            "DETAIL_EVAL": False, "IMAGE_THRE": 0.1, "NMS_THRE": 0.6, "SOFT_NMS": False,
            "OKS_THRE": 0.5, "IN_VIS_THRE": 0.0, "COCO_BBOX_FILE": "", "BBOX_THRE": 1.0,
            "MODEL_FILE": "",
        },
        "DEBUG": {"DEBUG": False, "SAVE_BATCH_IMAGES_GT": False, "SAVE_BATCH_IMAGES_PRED": False,
                  "SAVE_HEATMAPS_GT": False, "SAVE_HEATMAPS_PRED": False},
        # the JAX package's own section; the port reads it as DEVICE (to_port)
        "TPU": {
            "MESH_SHAPE": [-1], "MESH_AXES": ["data"], "COMPUTE_DTYPE": "bfloat16",
            "PARAM_DTYPE": "float32", "MAX_PERSONS": 7, "USE_PALLAS_ATTENTION": True,
            "FLASH_TRAIN_ATTENTION": True, "FUSED_FFN_TRAIN": True, "FUSED_MLP_EVAL": False,
            "FUSED_BLOCK_EVAL": True, "FUSED_BLOCK_EVAL_ONEPASS": False,
            "FUSED_BLOCK_TRAIN": False, "MIN_FUSED_TRAIN_TOKENS": 2048,
            "FUSED_TRAIN_MAX_BLOCKS": -1, "WINDOW_ATTN_EINSUM": False, "EVAL_PIPELINE": 2,
            "REMAT": False, "FROZEN_STAGE_EVAL_MODE": False,
        },
    }


def _literal(value, old):
    """yacs ``_decode_cfg_value``: a string over a default that is not one
    is read as a Python literal where it parses as one."""
    if isinstance(value, str) and not isinstance(old, str):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    return value


def _coerce(value, old):
    """yacs casts a list to the default's tuple and back."""
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(value)
    if isinstance(old, list) and isinstance(value, tuple):
        return list(value)
    return value


def merge(cfg: Dict[str, Any], other: Dict[str, Any]) -> Dict[str, Any]:
    """Merge ``other`` into ``cfg`` in place, ``other`` winning (the JAX
    ``Config.merge``: keys absent from the defaults are taken as they are)."""
    for k, v in other.items():
        if isinstance(v, dict) and isinstance(cfg.get(k), dict):
            merge(cfg[k], v)
        else:
            old = cfg.get(k)
            cfg[k] = _coerce(_literal(v, old), old)
    return cfg


def merge_from_list(cfg: Dict[str, Any], opts: List[Any]) -> Dict[str, Any]:
    """yacs ``KEY.SUBKEY value`` overrides, in place. A key absent from
    ``cfg`` raises ``KeyError``, except under ``MODEL.EXTRA`` (open in the
    reference schema)."""
    assert len(opts) % 2 == 0, f"override list must have even length, got {opts}"
    for key, value in zip(opts[0::2], opts[1::2]):
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            if p not in node:
                raise KeyError(f"Non-existent config key: {key}")
            node = node[p]
        open_subtree = parts[0] == "MODEL" and "EXTRA" in parts[1:]
        if parts[-1] not in node and not open_subtree:
            raise KeyError(f"Non-existent config key: {key}")
        old = node.get(parts[-1])
        node[parts[-1]] = _coerce(_literal(value, old), old)
    return cfg


def load_config(yaml_file: str, opts: Optional[List[Any]] = None, data_dir: str = "",
                model_dir: str = "", log_dir: str = "") -> Dict[str, Any]:
    """The config of a recipe YAML with yacs-style ``opts`` (the JAX
    ``load_config``, reference ``update_config``)."""
    cfg = default_config()
    loaded = yaml_lite.load_file(yaml_file)
    if loaded:
        merge(cfg, loaded)
    if opts:
        merge_from_list(cfg, list(opts))
    if model_dir:
        cfg["OUTPUT_DIR"] = model_dir
    if log_dir:
        cfg["LOG_DIR"] = log_dir
    if data_dir:
        cfg["DATA_DIR"] = data_dir
    cfg["DATASET"]["ROOT"] = os.path.join(cfg["DATA_DIR"], cfg["DATASET"]["ROOT"])
    cfg["MODEL"]["PRETRAINED"] = os.path.join(cfg["DATA_DIR"], cfg["MODEL"]["PRETRAINED"])
    if cfg["TEST"]["MODEL_FILE"]:
        cfg["TEST"]["MODEL_FILE"] = os.path.join(cfg["DATA_DIR"], cfg["TEST"]["MODEL_FILE"])
    return cfg


#: the keys of each section that the port reads
MODEL_KEYS = ("NAME", "NUM_JOINTS", "IMAGE_SIZE", "HEATMAP_SIZE", "TRANS_SIZE", "DIM_MODEL",
              "DIM_FEEDFORWARD", "N_HEAD", "ENCODER_LAYERS", "USE_MULTI_POS",
              "MULTI_POS_EMBEDDING", "SIGMA", "LOSS_WEIGHTS", "SINGLEFORMER", "SINGLEFORMER_FIX",
              "INTER_SUPERVISION", "ENCODER_MULTI_LAYERS", "UPSAMPLE_TYPE", "ATTENTION_TYPE",
              "DOMAIN_TRANS", "POS_EMBEDDING", "PE_ONLY_AT_BEGIN", "HRNET_RES_LAYER",
              "MULTI_POS_EMBEDDING_DIM", "WINDOW_SIZE",
              # weight sources and freezing (core/pretrained.py)
              "SINGLE_MODEL", "PRETRAINED", "INIT_WEIGHTS", "BACKBONE_FIX", "END2END",
              # the end-to-end models (models/interformer_e2e.py)
              "ENCODER_SINGLE_LAYERS", "ENCODER_MUTI_LAYERS", "SINGLE_POS_EMBEDDING")
TEST_KEYS = ("FLIP_TEST", "BLUR_KERNEL", "POST_PROCESS", "BATCH_SIZE_PER_GPU", "USE_GT_BBOX",
             "COCO_BBOX_FILE", "IMAGE_THRE", "IN_VIS_THRE", "OKS_THRE", "SOFT_NMS",
             "DETAIL_EVAL", "MODEL_FILE")
DATASET_KEYS = ("DATASET", "ROOT", "TRAIN_SET", "TEST_SET", "PATCH_MODE", "COLOR_RGB",
                "USE_COCOMINI", "MAX_PATCH", "SELECT_DATA", "SCALE_FACTOR", "ROT_FACTOR",
                "FLIP", "PROB_HALF_BODY", "NUM_JOINTS_HALF_BODY")
TRAIN_KEYS = ("BATCH_SIZE_PER_GPU", "BEGIN_EPOCH", "END_EPOCH", "LR", "LR_END", "OPTIMIZER",
              "MOMENTUM", "WD", "NESTEROV")
LOSS_KEYS = ("USE_OHKM", "TOPK", "USE_TARGET_WEIGHT", "USE_DIFFERENT_JOINTS_WEIGHT")
TOP_KEYS = ("SEED", "AUTO_RESUME", "PRINT_FREQ", "WORKERS", "OUTPUT_DIR", "LOG_DIR", "DATA_DIR")
#: the reference entry points' torch.backends.cudnn flags (``CUDNN``)
CUDNN_KEYS = ("BENCHMARK", "DETERMINISTIC", "ENABLED")
DEBUG_KEYS = ("DEBUG", "SAVE_BATCH_IMAGES_GT", "SAVE_BATCH_IMAGES_PRED", "SAVE_HEATMAPS_GT",
              "SAVE_HEATMAPS_PRED")


def plain(v):
    """``v`` with every mapping a dict and every tuple a list."""
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return copy.deepcopy(v)


def to_port(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """The port config of a config tree (``load_config``'s, or a JAX
    ``Config``, a dict too): the sections' keys that the port reads, and
    ``TPU`` as ``DEVICE`` (``USE_PALLAS_ATTENTION`` is ``USE_KERNELS``)."""
    tpu = cfg["TPU"]
    sec = {name: cfg[name] for name in ("MODEL", "DATASET", "TEST", "TRAIN", "LOSS")}
    return {
        "MODEL": {**{k: plain(sec["MODEL"][k]) for k in MODEL_KEYS},
                  "EXTRA": plain(sec["MODEL"]["EXTRA"])},
        "DATASET": {k: plain(sec["DATASET"][k]) for k in DATASET_KEYS},
        "TEST": {k: plain(sec["TEST"][k]) for k in TEST_KEYS},
        "DEVICE": {"COMPUTE_DTYPE": tpu["COMPUTE_DTYPE"],
                   "USE_KERNELS": bool(tpu["USE_PALLAS_ATTENTION"]),
                   "FLASH_TRAIN_ATTENTION": bool(tpu.get("FLASH_TRAIN_ATTENTION", True)),
                   "FUSED_FFN_TRAIN": bool(tpu.get("FUSED_FFN_TRAIN", True)),
                   "FUSED_BLOCK_EVAL": bool(tpu.get("FUSED_BLOCK_EVAL", True)),
                   "FUSED_BLOCK_EVAL_ONEPASS": bool(tpu.get("FUSED_BLOCK_EVAL_ONEPASS", False)),
                   "FUSED_MLP_EVAL": bool(tpu.get("FUSED_MLP_EVAL", False)),
                   "FUSED_BLOCK_TRAIN": bool(tpu.get("FUSED_BLOCK_TRAIN", False)),
                   "FROZEN_STAGE_EVAL_MODE": bool(tpu.get("FROZEN_STAGE_EVAL_MODE", False)),
                   "REMAT": plain(tpu.get("REMAT", False)),
                   "MAX_IMAGE_HW": plain(list(tpu.get("MAX_IMAGE_HW", (640, 640)))),
                   "EVAL_PIPELINE": int(tpu.get("EVAL_PIPELINE", 2))},
        "TRAIN": {k: plain(sec["TRAIN"][k]) for k in TRAIN_KEYS},
        "LOSS": {k: plain(sec["LOSS"][k]) for k in LOSS_KEYS},
        "DEBUG": {k: bool(cfg["DEBUG"][k]) for k in DEBUG_KEYS},
        "CUDNN": {k: bool(cfg["CUDNN"][k]) for k in CUDNN_KEYS},
        **{k: plain(cfg[k]) for k in TOP_KEYS},
    }


def apply_cudnn(cfg: Dict[str, Any]) -> Dict[str, bool]:
    """Set ``torch.backends.cudnn``'s ``benchmark``, ``deterministic`` and
    ``enabled`` from the config's ``CUDNN`` block (the default tree's where the
    config has none), as the reference's ``tools/train.py`` and ``tools/test.py``
    do before building the model; returns the flags set."""
    import torch

    flags = {**default_config()["CUDNN"], **cfg.get("CUDNN", {})}
    torch.backends.cudnn.benchmark = bool(flags["BENCHMARK"])
    torch.backends.cudnn.deterministic = bool(flags["DETERMINISTIC"])
    torch.backends.cudnn.enabled = bool(flags["ENABLED"])
    return {k: bool(flags[k]) for k in CUDNN_KEYS}
