"""The models by their ``MODEL.NAME`` and the datasets by their ``DATASET.DATASET``.

Port of ``i2rnet_tpu/registry.py`` (which replaced the reference's
``eval('models.' + cfg.MODEL.NAME + '.get_pose_net')`` and
``eval('dataset.' + cfg.DATASET.DATASET)`` at ``tools/train.py:102,129``)
over the ported names. Builders and classes are imported when first asked
for, so importing this module pulls in no model or dataset.
"""

from __future__ import annotations

from typing import Callable, Dict, Type


def _models() -> Dict[str, Callable]:
    from i2rnet_tpu_torch.models.interformer import build_interformer, build_transpose_h
    from i2rnet_tpu_torch.models.interformer_e2e import E2E_BUILDERS
    from i2rnet_tpu_torch.models.pure_multi import build_pure_multi

    # "transpose_h_old" is the JAX package's legacy alias of "transpose_h"
    return {"interformer_pureMulti": build_pure_multi, "interformer": build_interformer,
            "interformer_2stage": build_interformer, "transpose_h": build_transpose_h,
            "transpose_h_old": build_transpose_h, **E2E_BUILDERS}


def get_model_builder(name: str) -> Callable:
    """``builder(cfg, use_kernels=None, device="cuda")`` of ``MODEL.NAME``."""
    models = _models()
    if name not in models:
        raise KeyError(f"unknown model {name!r}; have {sorted(models)}")
    return models[name]


def _datasets() -> Dict[str, Type]:
    from i2rnet_tpu_torch.data.coco import COCODataset
    from i2rnet_tpu_torch.data.crowdpose import CROWDPOSEDataset
    from i2rnet_tpu_torch.data.mpii import MPIIDataset
    from i2rnet_tpu_torch.data.ochuman import CocoOCHumanDataset, OCHumanDataset

    return {"coco": COCODataset, "crowdpose": CROWDPOSEDataset, "OCHuman": OCHumanDataset,
            "coco_ochuman": CocoOCHumanDataset, "mpii": MPIIDataset}


def get_dataset_class(name: str) -> Type:
    datasets = _datasets()
    if name not in datasets:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(datasets)}")
    return datasets[name]
