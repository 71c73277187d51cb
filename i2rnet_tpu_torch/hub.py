"""Entry points that return a released configuration with its weights.

Port of ``hub.py`` of the JAX package (counterpart of the reference's
``hubconf.py``): each loader builds the model of a released configuration on
``device`` (the card unless the caller names another), in eval mode, and
loads ``checkpoint`` when given: a ``.pth`` under the reference's names or
one the port wrote (``core.pretrained.load_model_file``). Orbax directories
are not read: the port has no JAX. Without a checkpoint the model keeps its
builder's initial weights.

    from i2rnet_tpu_torch.hub import i2rnet_w48_pure
    model = i2rnet_w48_pure("coco", checkpoint="model_best.pth")

The TransPose-H configurations are their recipes' YAML files
(``experiments/<dataset>/interformer_<dataset>_tph_192_*.yaml``) read by
``config.config``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from torch import nn

#: the TransPose-H recipe of each dataset
TPH_RECIPES = {"coco": "coco/interformer_coco_tph_192_p4_b4.yaml",
               "crowdpose": "crowdpose/interformer_crowdpose_tph_192_p6_b4.yaml",
               "OCHuman": "OCHuman/interformer_ochuman_tph_192_p3_b8.yaml"}
EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"


def _load(cfg: Dict, checkpoint: Optional[str], device) -> nn.Module:
    from i2rnet_tpu_torch.core.pretrained import load_model_file
    from i2rnet_tpu_torch.registry import get_model_builder

    model = get_model_builder(cfg["MODEL"]["NAME"])(cfg, device=device)
    if checkpoint:
        load_model_file(checkpoint, model)
    return model


def _tph_config(dataset: str, max_patch: int) -> Dict:
    from i2rnet_tpu_torch.config.config import load_config, to_port

    if dataset not in TPH_RECIPES:
        raise KeyError(f"unknown dataset {dataset!r}; have {sorted(TPH_RECIPES)}")
    cfg = to_port(load_config(str(EXPERIMENTS / TPH_RECIPES[dataset])))
    cfg["DATASET"]["MAX_PATCH"] = int(max_patch)
    return cfg


def i2rnet_w48_pure(dataset: str = "coco", checkpoint: Optional[str] = None,
                    device="cuda") -> nn.Module:
    """Vanilla I²R-Net (HRNet-W48-S), 256x192 (``presets.w48_pure_en6``)."""
    from i2rnet_tpu_torch.presets import w48_pure_en6

    return _load(w48_pure_en6(dataset), checkpoint, device)


def i2rnet_tph(dataset: str = "coco", checkpoint: Optional[str] = None, max_patch: int = 4,
               device="cuda") -> nn.Module:
    """I²R-Net with the TransPose-H first stage, 256x192, from its recipe."""
    return _load(_tph_config(dataset, max_patch), checkpoint, device)


def transpose_h(dataset: str = "coco", checkpoint: Optional[str] = None,
                device="cuda") -> nn.Module:
    """The standalone TransPose-H single-person model of that recipe."""
    cfg = _tph_config(dataset, 4)
    cfg["MODEL"]["NAME"] = "transpose_h"
    return _load(cfg, checkpoint, device)
