"""Model configurations as plain dicts (no YAML, no config package).

Mirrors ``i2rnet_tpu/presets.py:70,190`` and
``experiments/coco/interformer_coco_w48_pure_en6.yaml``, keeping only the keys
the ported serving and training paths read, under the JAX config's section
and key names. The one renamed section is ``DEVICE``: ``COMPUTE_DTYPE`` and
``USE_KERNELS`` (the JAX ``TPU.COMPUTE_DTYPE`` and ``TPU.USE_PALLAS_ATTENTION``;
the recipe's ``FLASH_TRAIN_ATTENTION`` and ``FUSED_FFN_TRAIN`` are on, so the
one flag also routes training through Kernels C and D).
"""

from __future__ import annotations

import copy
from typing import Dict

#: COCO left/right joint pairs (``i2rnet_tpu/data/coco.py:37``)
COCO_FLIP_PAIRS = [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12],
                   [13, 14], [15, 16]]

#: COCO limb up-weighting (``i2rnet_tpu/data/coco.py:42``, reference coco.py:106-112)
COCO_JOINTS_WEIGHT = (1., 1., 1., 1., 1., 1., 1., 1.2, 1.2,
                      1.5, 1.5, 1., 1., 1.2, 1.2, 1.5, 1.5)

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
               "USE_MULTI_POS", "MULTI_POS_EMBEDDING", "SIGMA", "LOSS_WEIGHTS")
_TEST_KEYS = ("FLIP_TEST", "BLUR_KERNEL", "POST_PROCESS")
_TRAIN_KEYS = ("BATCH_SIZE_PER_GPU", "BEGIN_EPOCH", "END_EPOCH", "LR", "LR_END", "OPTIMIZER",
               "MOMENTUM", "WD", "NESTEROV")
_LOSS_KEYS = ("USE_OHKM", "TOPK", "USE_TARGET_WEIGHT", "USE_DIFFERENT_JOINTS_WEIGHT")
_TOP_KEYS = ("SEED", "AUTO_RESUME", "PRINT_FREQ")


def _training(batch: int, end_epoch: int, lr: float, lr_end: float, wd: float) -> Dict:
    """The training sections and top-level keys shared by the presets."""
    return {
        "TRAIN": {"BATCH_SIZE_PER_GPU": batch, "BEGIN_EPOCH": 0, "END_EPOCH": end_epoch,
                  "LR": lr, "LR_END": lr_end, "OPTIMIZER": "adam", "MOMENTUM": 0.9, "WD": wd,
                  "NESTEROV": False},
        "LOSS": {"USE_OHKM": False, "TOPK": 8, "USE_TARGET_WEIGHT": True,
                 "USE_DIFFERENT_JOINTS_WEIGHT": False},
        "SEED": 0, "AUTO_RESUME": True, "PRINT_FREQ": 100,
    }


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
            "SIGMA": 2,
            "LOSS_WEIGHTS": [0.5, 0.5],
            "EXTRA": copy.deepcopy(HRNET_W48S_EXTRA),
        },
        "DATASET": {"DATASET": "coco", "MAX_PATCH": 7},
        "TEST": {"FLIP_TEST": True, "BLUR_KERNEL": 11, "POST_PROCESS": True},
        "DEVICE": {"COMPUTE_DTYPE": "bfloat16", "USE_KERNELS": True},
        **_training(batch=8, end_epoch=240, lr=5e-4, lr_end=5e-5, wd=0.1),
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
            "SIGMA": 2,
            "LOSS_WEIGHTS": [0.5, 0.5],
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
        "DATASET": {"DATASET": "synthetic", "MAX_PATCH": 7},
        "TEST": {"FLIP_TEST": True, "BLUR_KERNEL": 11, "POST_PROCESS": True},
        "DEVICE": {"COMPUTE_DTYPE": "float32", "USE_KERNELS": False},
        **_training(batch=2, end_epoch=2, lr=1e-4, lr_end=1e-5, wd=1e-4),
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
        "DATASET": {"DATASET": cfg.DATASET.DATASET, "MAX_PATCH": cfg.DATASET.MAX_PATCH},
        "TEST": {k: _plain(getattr(cfg.TEST, k)) for k in _TEST_KEYS},
        "DEVICE": {"COMPUTE_DTYPE": cfg.TPU.COMPUTE_DTYPE,
                   "USE_KERNELS": bool(cfg.TPU.USE_PALLAS_ATTENTION)},
        "TRAIN": {k: _plain(getattr(cfg.TRAIN, k)) for k in _TRAIN_KEYS},
        "LOSS": {k: _plain(getattr(cfg.LOSS, k)) for k in _LOSS_KEYS},
        **{k: _plain(getattr(cfg, k)) for k in _TOP_KEYS},
    }
