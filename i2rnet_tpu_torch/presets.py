"""Model configurations as plain dicts (no YAML, no config package).

Mirrors ``i2rnet_tpu/presets.py:70,104,141,190`` and the recipes
``experiments/coco/interformer_coco_w48_pure_en6.yaml`` (and its CrowdPose
and OCHuman variants under ``experiments/crowdpose`` and
``experiments/OCHuman``), ``interformer_coco_hrt_192_p2_b12.yaml`` and
``interformer_coco_tph_192_p4_b4.yaml``, keeping only the keys the ported
paths read, under the JAX config's section and key names. The one renamed
section is ``DEVICE``: ``COMPUTE_DTYPE``, ``USE_KERNELS`` (the JAX
``TPU.COMPUTE_DTYPE`` and ``TPU.USE_PALLAS_ATTENTION``, the master switch of
every kernel route), ``FLASH_TRAIN_ATTENTION`` and ``FUSED_FFN_TRAIN`` (the
encoder's training attention on Kernel C and its training tail on Kernel D,
each where ``USE_KERNELS`` is on too; on, as the JAX defaults and every
recipe), ``FUSED_BLOCK_EVAL`` (HRFormer blocks on Kernels E and F),
``FUSED_BLOCK_EVAL_ONEPASS`` (each block in one launch of kernel 7 in place
of E and F; off, as in every recipe), ``FUSED_MLP_EVAL`` (their MlpDWBN on
Kernel G where E and F are off), ``FUSED_BLOCK_TRAIN`` (the HRFormer blocks'
attention half on kernel 9 in training), and ``FROZEN_STAGE_EVAL_MODE`` and
``REMAT``, which the port does not implement (a training forward of either
model with one of them set raises). One key is the
port's own: ``MODEL.HRFORMER_ARCH``, the HRFormer architecture (the JAX
builder's ``arch=`` argument; HRFormer-B when absent). The JAX gates
``TPU.MIN_FUSED_TRAIN_TOKENS`` and ``TPU.FUSED_TRAIN_MAX_BLOCKS`` are not
carried: they cap what the TPU compiler is given, and every block takes
kernel 9 when its route is on. ``DEVICE`` also carries the data path's
``MAX_IMAGE_HW`` (the static raw-image raster, ``[h, w]``) and
``EVAL_PIPELINE`` (the batches ``validate`` keeps in flight), the JAX
``TPU.MAX_IMAGE_HW`` and ``TPU.EVAL_PIPELINE``.

``DATASET``, ``TEST`` and ``WORKERS`` hold what the evaluation slice reads
(``data/dataset.py``, ``data/coco.py``, ``core/validate.py``), the training
augmentation's keys among them. ``w48_pure_en6``, ``hrt_interformer`` and
``tph_interformer`` take their recipes' values, data location included (``ROOT``,
``TRAIN_SET``, ``TEST_SET``, ``COCO_BBOX_FILE``), which the JAX presets
leave at the config defaults; the tiny configs take the JAX presets'.
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
#: COCO's half-body split (``i2rnet_tpu/data/coco.py:39-40``)
COCO_UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10)
COCO_LOWER_BODY_IDS = (11, 12, 13, 14, 15, 16)

#: CrowdPose's 14-joint skeleton (``i2rnet_tpu/data/crowdpose.py:25-31``,
#: reference crowdpose.py:104-110): flip pairs, half-body split, limb weights
CROWDPOSE_FLIP_PAIRS = [[0, 1], [2, 3], [4, 5], [6, 7], [8, 9], [10, 11]]
CROWDPOSE_UPPER_BODY_IDS = (0, 1, 2, 3, 4, 5, 12, 13)
CROWDPOSE_LOWER_BODY_IDS = (6, 7, 8, 9, 10, 11)
CROWDPOSE_JOINTS_WEIGHT = (1., 1., 1.2, 1.2, 1.5, 1.5, 1., 1., 1.2,
                           1.2, 1.5, 1.5, 1., 1.)

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
               "USE_MULTI_POS", "MULTI_POS_EMBEDDING", "SIGMA", "LOSS_WEIGHTS",
               "SINGLEFORMER", "SINGLEFORMER_FIX", "INTER_SUPERVISION", "ENCODER_MULTI_LAYERS",
               "UPSAMPLE_TYPE", "ATTENTION_TYPE", "DOMAIN_TRANS", "POS_EMBEDDING",
               "PE_ONLY_AT_BEGIN", "HRNET_RES_LAYER", "MULTI_POS_EMBEDDING_DIM")
_TEST_KEYS = ("FLIP_TEST", "BLUR_KERNEL", "POST_PROCESS", "BATCH_SIZE_PER_GPU", "USE_GT_BBOX",
              "COCO_BBOX_FILE", "IMAGE_THRE", "IN_VIS_THRE", "OKS_THRE", "SOFT_NMS",
              "DETAIL_EVAL")
_DATASET_KEYS = ("DATASET", "ROOT", "TRAIN_SET", "TEST_SET", "PATCH_MODE", "COLOR_RGB",
                 "USE_COCOMINI", "MAX_PATCH", "SELECT_DATA", "SCALE_FACTOR", "ROT_FACTOR",
                 "FLIP", "PROB_HALF_BODY", "NUM_JOINTS_HALF_BODY")
_TRAIN_KEYS = ("BATCH_SIZE_PER_GPU", "BEGIN_EPOCH", "END_EPOCH", "LR", "LR_END", "OPTIMIZER",
               "MOMENTUM", "WD", "NESTEROV")
_LOSS_KEYS = ("USE_OHKM", "TOPK", "USE_TARGET_WEIGHT", "USE_DIFFERENT_JOINTS_WEIGHT")
_TOP_KEYS = ("SEED", "AUTO_RESUME", "PRINT_FREQ", "WORKERS")
#: the recipes' data location (``experiments/coco/*.yaml``, ``DATASET`` and
#: ``TEST.COCO_BBOX_FILE``; every recipe names the COCO detections file)
COCO_RECIPE_DATA = {"ROOT": "data/coco/", "TRAIN_SET": "train2017", "TEST_SET": "val2017"}
#: the W48 recipe of each dataset (``experiments/{coco,crowdpose,OCHuman}/
#: interformer_*_w48_pure_en6.yaml``): joints, data location, MAX_PATCH, the
#: position embedding, the test batch, and TRAIN's batch, LR and LR_END
W48_RECIPES = {
    "coco": {"joints": 17, "data": COCO_RECIPE_DATA, "max_patch": 7, "multi_pos": True,
             "test_batch": 64, "batch": 8, "lr": 5e-4, "lr_end": 5e-5},
    "crowdpose": {"joints": 14, "data": {"ROOT": "data/crowdpose/", "TRAIN_SET": "trainval",
                                         "TEST_SET": "test"},
                  "max_patch": 5, "multi_pos": True, "test_batch": 64, "batch": 32,
                  "lr": 1e-4, "lr_end": 1e-5},
    "OCHuman": {"joints": 17, "data": {
        "ROOT": "data/OCHuman/", "TRAIN_SET": "ochuman_coco_format_val_range_0.00_1.00.json",
        "TEST_SET": "ochuman_coco_format_test_range_0.00_1.00.json"},
        "max_patch": 3, "multi_pos": False, "test_batch": 128, "batch": 32, "lr": 1e-4,
        "lr_end": 1e-5},
}
COCO_RECIPE_BBOX_FILE = ("data/coco/person_detection_results/"
                         "COCO_val2017_detections_AP_H_56_person.json")


def _device(dtype: str, use_kernels: bool, fused_block_train: bool = False) -> Dict:
    return {"COMPUTE_DTYPE": dtype, "USE_KERNELS": use_kernels, "FLASH_TRAIN_ATTENTION": True,
            "FUSED_FFN_TRAIN": True, "FUSED_BLOCK_EVAL": True,
            "FUSED_BLOCK_EVAL_ONEPASS": False, "FUSED_MLP_EVAL": False,
            "FUSED_BLOCK_TRAIN": fused_block_train, "FROZEN_STAGE_EVAL_MODE": False,
            "REMAT": False, "MAX_IMAGE_HW": [640, 640], "EVAL_PIPELINE": 2}


def _dataset(name: str, max_patch: int, **location) -> Dict:
    """``DATASET``: the JAX presets' values (``i2rnet_tpu/presets.py::_base``
    and the config defaults), the data location from ``location``."""
    return {"DATASET": name, "ROOT": "", "TRAIN_SET": "train", "TEST_SET": "valid",
            "PATCH_MODE": "random", "COLOR_RGB": True, "USE_COCOMINI": False,
            "MAX_PATCH": max_patch, "SELECT_DATA": False, "SCALE_FACTOR": 0.35,
            "ROT_FACTOR": 45, "FLIP": True, "PROB_HALF_BODY": 0.3, "NUM_JOINTS_HALF_BODY": 8,
            **location}


def _test(batch: int, bbox_file: str = "") -> Dict:
    """``TEST``: the eval protocol of every recipe (flip test, DARK with blur 11,
    GT boxes, OKS-NMS at 0.9 after rescoring at 0.2)."""
    return {"FLIP_TEST": True, "BLUR_KERNEL": 11, "POST_PROCESS": True,
            "BATCH_SIZE_PER_GPU": batch, "USE_GT_BBOX": True, "COCO_BBOX_FILE": bbox_file,
            "IMAGE_THRE": 0.0, "IN_VIS_THRE": 0.2, "OKS_THRE": 0.9, "SOFT_NMS": False,
            "DETAIL_EVAL": False}


def _training(batch: int, end_epoch: int, lr: float, lr_end: float, wd: float) -> Dict:
    """The training sections and top-level keys shared by the presets."""
    return {
        "TRAIN": {"BATCH_SIZE_PER_GPU": batch, "BEGIN_EPOCH": 0, "END_EPOCH": end_epoch,
                  "LR": lr, "LR_END": lr_end, "OPTIMIZER": "adam", "MOMENTUM": 0.9, "WD": wd,
                  "NESTEROV": False},
        "LOSS": {"USE_OHKM": False, "TOPK": 8, "USE_TARGET_WEIGHT": True,
                 "USE_DIFFERENT_JOINTS_WEIGHT": False},
        "SEED": 0, "AUTO_RESUME": True, "PRINT_FREQ": 100, "WORKERS": 8,
        "DEBUG": {"DEBUG": False},
    }


def w48_pure_en6(dataset: str = "coco") -> Dict:
    """Vanilla I²R-Net: HRNet-W48-S + 6-layer inter encoder, 256x192, on
    ``dataset`` (``"coco"``, ``"crowdpose"`` or ``"OCHuman"``), as the JAX
    preset of that name (14 joints for CrowdPose) with its recipe's YAML
    merged over it: MAX_PATCH 7, 5 and 3; ``TRAIN.BATCH_SIZE_PER_GPU`` 8, 32
    and 32 at LR 5e-4, 1e-4 and 1e-4 (to 5e-5, 1e-5, 1e-5); OCHuman's
    ``USE_MULTI_POS`` false (no position embedding) and test batch 128."""
    if dataset not in W48_RECIPES:
        raise KeyError(f"unknown dataset {dataset!r}; have {sorted(W48_RECIPES)}")
    r = W48_RECIPES[dataset]
    return {
        "MODEL": {
            "NAME": "interformer_pureMulti",
            "NUM_JOINTS": r["joints"],
            "IMAGE_SIZE": [192, 256],     # [w, h]
            "HEATMAP_SIZE": [48, 64],     # [w, h]
            "TRANS_SIZE": [16, 12],       # [h, w] token grid
            "DIM_MODEL": 96,
            "DIM_FEEDFORWARD": 192,
            "N_HEAD": 1,
            "ENCODER_LAYERS": 6,
            "USE_MULTI_POS": r["multi_pos"],
            "MULTI_POS_EMBEDDING": "conv",
            "SIGMA": 2,
            "LOSS_WEIGHTS": [0.5, 0.5],
            "EXTRA": copy.deepcopy(HRNET_W48S_EXTRA),
        },
        "DATASET": _dataset(dataset, r["max_patch"], **r["data"]),
        "TEST": _test(r["test_batch"], COCO_RECIPE_BBOX_FILE),
        "DEVICE": _device("bfloat16", True),
        **_training(batch=r["batch"], end_epoch=240, lr=r["lr"], lr_end=r["lr_end"], wd=0.1),
    }


def _hrt_extra(filters: int) -> Dict:
    """The HRFormer two-stage models' deconv head (filters = DIM_MODEL)."""
    return {"DECONV_WITH_BIAS": False, "NUM_DECONV_LAYERS": 1, "NUM_DECONV_FILTERS": [filters],
            "NUM_DECONV_KERNELS": [4], "FINAL_CONV_KERNEL": 1}


def _hrt_model(num_joints, image_size, heatmap_size, trans_size, d_model, dim_ff, n_head,
               layers) -> Dict:
    return {
        "NAME": "interformer", "SINGLEFORMER": "hrformer", "SINGLEFORMER_FIX": False,
        "INTER_SUPERVISION": True, "NUM_JOINTS": num_joints, "IMAGE_SIZE": list(image_size),
        "HEATMAP_SIZE": list(heatmap_size), "TRANS_SIZE": list(trans_size),
        "DIM_MODEL": d_model, "DIM_FEEDFORWARD": dim_ff, "N_HEAD": n_head,
        "ENCODER_LAYERS": 6, "ENCODER_MULTI_LAYERS": layers, "USE_MULTI_POS": False,
        "MULTI_POS_EMBEDDING": "res", "UPSAMPLE_TYPE": "deconv", "ATTENTION_TYPE": "default",
        "DOMAIN_TRANS": False, "SIGMA": 2, "LOSS_WEIGHTS": [0.5, 0.5],
        "EXTRA": _hrt_extra(d_model),
    }


def hrt_interformer(image_size=(192, 256)) -> Dict:
    """I²R-Net with the HRFormer-B first stage on COCO (``[w, h]`` input):
    DIM_MODEL 78 = branch 0's width, 2 inter layers, no multi-person
    position embedding, deconv upsampling, MAX_PATCH 2.

    ``DEVICE.FUSED_BLOCK_TRAIN`` is on here, so training runs kernel 9 on
    every HRFormer block's attention half. The JAX recipe leaves its
    ``TPU.FUSED_BLOCK_TRAIN`` off: it was retired for a TPU reason (the
    window relayouts it removes fed the matrix unit, ``docs/KERNELS.md:25``).
    Both routes compute the same function; the measurement on the H100
    (PERF.md) decides whether the port keeps it on.

    ``hrt_interformer((288, 384))`` is the 384x288 recipe
    (``interformer_coco_hrt_288_p2_b4.yaml``). Its ``TRANS_SIZE`` (24, 18)
    differs from the YAML's [9, 12], as the JAX preset's does; both take the
    same two 3x3/s2 pools (floored log2 of 72 / 18 and of 72 / 12), so the
    token grid and the model are the same.

    ``TRAIN`` is the recipe's: ``BATCH_SIZE_PER_GPU`` 12 and ``WD`` 0.1 at
    256x192 (``interformer_coco_hrt_192_p2_b12.yaml:172,191``), 4 and 0.1 at
    384x288. The JAX preset keeps 4 and 1e-4. ``TEST.BATCH_SIZE_PER_GPU`` is
    the recipe's 64 too (the JAX preset: 32)."""
    w, h = image_size
    return {
        "MODEL": _hrt_model(17, (w, h), (w // 4, h // 4), (h // 16, w // 16), 78, 192, 1, 2),
        "DATASET": _dataset("coco", 2, **COCO_RECIPE_DATA),
        "TEST": _test(64, COCO_RECIPE_BBOX_FILE),
        "DEVICE": _device("bfloat16", True, fused_block_train=True),
        **_training(batch=12 if tuple(image_size) == (192, 256) else 4, end_epoch=240,
                    lr=1e-4, lr_end=1e-5, wd=0.1),
    }


def _tph_model(num_joints, image_size, heatmap_size, trans_size, d_model, dim_ff, n_head,
               layers, multi_layers, extra) -> Dict:
    return {
        "NAME": "interformer_2stage", "SINGLEFORMER": "transpose_h", "SINGLEFORMER_FIX": False,
        "INTER_SUPERVISION": True, "NUM_JOINTS": num_joints, "IMAGE_SIZE": list(image_size),
        "HEATMAP_SIZE": list(heatmap_size), "TRANS_SIZE": list(trans_size),
        "DIM_MODEL": d_model, "DIM_FEEDFORWARD": dim_ff, "N_HEAD": n_head,
        "ENCODER_LAYERS": layers, "ENCODER_MULTI_LAYERS": multi_layers,
        "POS_EMBEDDING": "sine", "PE_ONLY_AT_BEGIN": False, "HRNET_RES_LAYER": 0,
        "USE_MULTI_POS": True, "MULTI_POS_EMBEDDING": "conv", "MULTI_POS_EMBEDDING_DIM": d_model,
        "UPSAMPLE_TYPE": "multiplex", "ATTENTION_TYPE": "default", "DOMAIN_TRANS": False,
        "SIGMA": 2, "LOSS_WEIGHTS": [0.5, 0.5], "EXTRA": extra,
    }


def tph_interformer() -> Dict:
    """I²R-Net with the TransPose-H first stage on COCO, 256x192
    (``experiments/coco/interformer_coco_tph_192_p4_b4.yaml``): the HRNet-W48-S
    trunk (stages 2-3), its 64x48 branch 0 reduced to DIM_MODEL 96 and a
    6-layer intra encoder over the 3072 tokens of each person with a sine
    position embedding in every layer; then a 4-layer inter encoder
    (``ENCODER_MULTI_LAYERS`` 4, the YAML's value, which the JAX builder
    reads; the JAX preset keeps 2) over the 16x12-pooled tokens of up to
    MAX_PATCH 4 persons with the box-mask ``conv`` position embedding, and one
    deconv block applied twice (``multiplex``). ``TEST.BATCH_SIZE_PER_GPU`` 64
    and ``TRAIN.BATCH_SIZE_PER_GPU`` 4, as the recipe.

    Served, evaluated and trained: ``TRAIN`` and ``LOSS`` are the JAX
    preset's merged with the YAML (Adam at LR 1e-4 down to 1e-5 over 240
    epochs, ``WD`` 0.1, target weights), and training runs Kernels C and D in
    both encoders (``FLASH_TRAIN_ATTENTION``, ``FUSED_FFN_TRAIN``), dropout
    0.1, with inter-supervision at ``LOSS_WEIGHTS`` [0.5, 0.5]."""
    return {
        "MODEL": _tph_model(17, (192, 256), (48, 64), (16, 12), 96, 192, 1, 6, 4,
                            copy.deepcopy(HRNET_W48S_EXTRA)),
        "DATASET": _dataset("coco", 4, **COCO_RECIPE_DATA),
        "TEST": _test(64, COCO_RECIPE_BBOX_FILE),
        "DEVICE": _device("bfloat16", True),
        **_training(batch=4, end_epoch=240, lr=1e-4, lr_end=1e-5, wd=0.1),
    }


#: a small HRFormer for CPU tests (``tests/test_hrformer.py:21`` of the JAX package)
TINY_HRFORMER_ARCH = {
    "drop_path_rate": 0.1,
    "stage2": dict(num_modules=1, num_branches=2, num_blocks=(1, 1),
                   num_channels=(16, 32), num_heads=(2, 2),
                   num_mlp_ratios=(2, 2), num_window_sizes=(7, 7)),
    "stage3": dict(num_modules=1, num_branches=3, num_blocks=(1, 1, 1),
                   num_channels=(16, 32, 64), num_heads=(2, 2, 2),
                   num_mlp_ratios=(2, 2, 2), num_window_sizes=(7, 7, 7)),
    "stage4": dict(num_modules=1, num_branches=4, num_blocks=(1, 1, 1, 1),
                   num_channels=(16, 32, 64, 128), num_heads=(2, 2, 2, 2),
                   num_mlp_ratios=(2, 2, 2, 2), num_window_sizes=(7, 7, 7, 7)),
}


def tiny_hrt_config(num_joints: int = 5) -> Dict:
    """Small HRFormer two-stage config for CPU tests (64x48 input, d_model 16)."""
    return {
        "MODEL": {**_hrt_model(num_joints, (48, 64), (12, 16), (4, 3), 16, 32, 2, 2),
                  "HRFORMER_ARCH": copy.deepcopy(TINY_HRFORMER_ARCH)},
        "DATASET": _dataset("synthetic", 7),
        "TEST": _test(32),
        "DEVICE": _device("float32", False),
        **_training(batch=2, end_epoch=2, lr=1e-4, lr_end=1e-5, wd=1e-4),
    }


def tiny_tph_config(num_joints: int = 5) -> Dict:
    """Small TransPose-H two-stage config for CPU tests, as the JAX tests'
    ``tests/test_interformer.py::tiny_interformer_cfg`` (64x48 input, d_model
    16, two heads, one intra and one inter layer, the tiny HRNet trunk) in
    the recipe's composition (multiplex upsampling, the ``conv`` box-mask
    position embedding of dim 8)."""
    extra = copy.deepcopy(tiny_test_config()["MODEL"]["EXTRA"])
    model = _tph_model(num_joints, (48, 64), (12, 16), (4, 3), 16, 32, 2, 1, 1, extra)
    model["MULTI_POS_EMBEDDING_DIM"] = 8
    return {
        "MODEL": model,
        "DATASET": _dataset("synthetic", 7),
        "TEST": _test(32),
        "DEVICE": _device("float32", False),
        **_training(batch=2, end_epoch=2, lr=1e-4, lr_end=1e-5, wd=1e-4),
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
        "DATASET": _dataset("synthetic", 7),
        "TEST": _test(32),
        "DEVICE": _device("float32", False),
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
        "DATASET": {k: _plain(getattr(cfg.DATASET, k)) for k in _DATASET_KEYS},
        "TEST": {k: _plain(getattr(cfg.TEST, k)) for k in _TEST_KEYS},
        "DEVICE": {"COMPUTE_DTYPE": cfg.TPU.COMPUTE_DTYPE,
                   "USE_KERNELS": bool(cfg.TPU.USE_PALLAS_ATTENTION),
                   "FLASH_TRAIN_ATTENTION": bool(cfg.TPU.get("FLASH_TRAIN_ATTENTION", True)),
                   "FUSED_FFN_TRAIN": bool(cfg.TPU.get("FUSED_FFN_TRAIN", True)),
                   "FUSED_BLOCK_EVAL": bool(cfg.TPU.get("FUSED_BLOCK_EVAL", True)),
                   "FUSED_BLOCK_EVAL_ONEPASS": bool(cfg.TPU.get("FUSED_BLOCK_EVAL_ONEPASS",
                                                                False)),
                   "FUSED_MLP_EVAL": bool(cfg.TPU.get("FUSED_MLP_EVAL", False)),
                   "FUSED_BLOCK_TRAIN": bool(cfg.TPU.get("FUSED_BLOCK_TRAIN", False)),
                   "FROZEN_STAGE_EVAL_MODE": bool(cfg.TPU.get("FROZEN_STAGE_EVAL_MODE", False)),
                   "REMAT": _plain(cfg.TPU.get("REMAT", False)),
                   "MAX_IMAGE_HW": _plain(list(cfg.TPU.get("MAX_IMAGE_HW", (640, 640)))),
                   "EVAL_PIPELINE": int(cfg.TPU.get("EVAL_PIPELINE", 2))},
        "TRAIN": {k: _plain(getattr(cfg.TRAIN, k)) for k in _TRAIN_KEYS},
        "LOSS": {k: _plain(getattr(cfg.LOSS, k)) for k in _LOSS_KEYS},
        "DEBUG": {"DEBUG": bool(cfg.DEBUG.DEBUG)},
        **{k: _plain(getattr(cfg, k)) for k in _TOP_KEYS},
    }
