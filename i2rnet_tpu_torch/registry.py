"""The datasets by their ``DATASET.DATASET`` names.

Port of the dataset half of ``i2rnet_tpu/registry.py`` (which replaced the
reference's ``eval('dataset.' + cfg.DATASET.DATASET)`` at
``tools/train.py:129``). The classes are imported when first asked for, so
importing this module pulls in no dataset.
"""

from __future__ import annotations

from typing import Dict, Type


def _datasets() -> Dict[str, Type]:
    from i2rnet_tpu_torch.data.coco import COCODataset
    from i2rnet_tpu_torch.data.crowdpose import CROWDPOSEDataset
    from i2rnet_tpu_torch.data.ochuman import CocoOCHumanDataset, OCHumanDataset

    return {"coco": COCODataset, "crowdpose": CROWDPOSEDataset, "OCHuman": OCHumanDataset,
            "coco_ochuman": CocoOCHumanDataset}


def get_dataset_class(name: str) -> Type:
    datasets = _datasets()
    if name not in datasets:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(datasets)}")
    return datasets[name]
