"""Model configurations as plain dicts (no YAML, no config package).

Mirrors ``i2rnet_tpu/presets.py:70,190`` and
``experiments/coco/interformer_coco_w48_pure_en6.yaml``, keeping only the keys
the ported serving path reads, under the JAX config's section and key names.
The one renamed section is ``DEVICE``: ``COMPUTE_DTYPE`` and ``USE_KERNELS``
(the JAX ``TPU.COMPUTE_DTYPE`` and ``TPU.USE_PALLAS_ATTENTION``).
"""

from __future__ import annotations

import copy
from typing import Dict

#: COCO left/right joint pairs (``i2rnet_tpu/data/coco.py:37``)
COCO_FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]]

HRNET_W48S_EXTRA = {
    "DECONV_WITH_BIAS": False,
    "NUM_DECONV_LAYERS": 1,
    "NUM_DECONV_FILTERS": [96],
    "NUM_DECONV_KERNELS": [4],
    "FINAL_CONV_KERNEL": 1,
    "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
               "NUM_BLOCKS": [4, 4], "NUM_CHANNELS": [48, 96], "FUSE_METHOD": "SUM"},
    "STAGE3": {"NUM_MODULES": 4, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
               "NUM_BLOCKS": [4, 4, 4], "NUM_CHANNELS": [48, 96, 192], "FUSE_METHOD": "SUM"},
}

_MODEL_KEYS = ("NAME", "NUM_JOINTS", "IMAGE_SIZE", "HEATMAP_SIZE", "TRANS_SIZE",
               "DIM_MODEL", "DIM_FEEDFORWARD", "N_HEAD", "ENCODER_LAYERS",
               "USE_MULTI_POS", "MULTI_POS_EMBEDDING")
_TEST_KEYS = ("FLIP_TEST", "BLUR_KERNEL", "POST_PROCESS")


def w48_pure_en6() -> Dict:
    """Vanilla I²R-Net on COCO: HRNet-W48-S + 6-layer inter encoder, 256x192."""
    return {
        "MODEL": {
            "NAME": "interformer_pureMulti",
            "NUM_JOINTS": 17,
            "IMAGE_SIZE": [192, 256],     # [w, h]
            "HEATMAP_SIZE": [48, 64],     # [w, h]
            "TRANS_SIZE": [16, 12],       # [h, w] token grid
            "DIM_MODEL": 96,
            "DIM_FEEDFORWARD": 192,
            "N_HEAD": 1,
            "ENCODER_LAYERS": 6,
            "USE_MULTI_POS": True,
            "MULTI_POS_EMBEDDING": "conv",
            "EXTRA": copy.deepcopy(HRNET_W48S_EXTRA),
        },
        "DATASET": {"DATASET": "coco"},
        "TEST": {"FLIP_TEST": True, "BLUR_KERNEL": 11, "POST_PROCESS": True},
        "DEVICE": {"COMPUTE_DTYPE": "bfloat16", "USE_KERNELS": True},
    }


def tiny_test_config(num_joints: int = 5) -> Dict:
    """Small config for CPU tests (64x48 input), as the JAX package's."""
    return {
        "MODEL": {
            "NAME": "interformer_pureMulti",
            "NUM_JOINTS": num_joints,
            "IMAGE_SIZE": [48, 64],
            "HEATMAP_SIZE": [12, 16],
            "TRANS_SIZE": [4, 3],
            "DIM_MODEL": 16,
            "DIM_FEEDFORWARD": 32,
            "N_HEAD": 2,
            "ENCODER_LAYERS": 2,
            "USE_MULTI_POS": True,
            "MULTI_POS_EMBEDDING": "conv",
            "EXTRA": {
                "DECONV_WITH_BIAS": False,
                "NUM_DECONV_LAYERS": 1,
                "NUM_DECONV_FILTERS": [16],
                "NUM_DECONV_KERNELS": [4],
                "FINAL_CONV_KERNEL": 1,
                "STAGE2": {"NUM_MODULES": 1, "NUM_BRANCHES": 2, "BLOCK": "BASIC",
                           "NUM_BLOCKS": [1, 1], "NUM_CHANNELS": [8, 16],
                           "FUSE_METHOD": "SUM"},
                "STAGE3": {"NUM_MODULES": 1, "NUM_BRANCHES": 3, "BLOCK": "BASIC",
                           "NUM_BLOCKS": [1, 1, 1], "NUM_CHANNELS": [8, 16, 32],
                           "FUSE_METHOD": "SUM"},
            },
        },
        "DATASET": {"DATASET": "synthetic"},
        "TEST": {"FLIP_TEST": True, "BLUR_KERNEL": 11, "POST_PROCESS": True},
        "DEVICE": {"COMPUTE_DTYPE": "float32", "USE_KERNELS": False},
    }


def _plain(v):
    if hasattr(v, "to_dict"):
        v = v.to_dict()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


def from_config(cfg) -> Dict:
    """A port config from a JAX ``Config`` (read by attribute access only)."""
    return {
        "MODEL": {**{k: _plain(getattr(cfg.MODEL, k)) for k in _MODEL_KEYS},
                  "EXTRA": _plain(cfg.MODEL.EXTRA)},
        "DATASET": {"DATASET": cfg.DATASET.DATASET},
        "TEST": {k: _plain(getattr(cfg.TEST, k)) for k in _TEST_KEYS},
        "DEVICE": {"COMPUTE_DTYPE": cfg.TPU.COMPUTE_DTYPE,
                   "USE_KERNELS": bool(cfg.TPU.USE_PALLAS_ATTENTION)},
    }
