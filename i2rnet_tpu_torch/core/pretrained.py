"""First-stage and backbone weights for training, and the frozen parameters.

Port of ``i2rnet_tpu/core/pretrained.py`` (the reference's factory-time
loading, ``lib/models/transpose_h.py:691-706``, ``hrformer.py:2487-2533``,
``interformer_pureMulti.py:780-821``):

* :func:`load_pretrained` follows the JAX dispatch: a two-stage model
  (``SINGLEFORMER`` set, not ``END2END``) takes ``MODEL.SINGLE_MODEL`` into
  its ``singleformer``, and only warns without one; with ``END2END`` it takes
  ``MODEL.PRETRAINED`` there; a model without a first stage takes
  ``MODEL.PRETRAINED`` at its root where ``INIT_WEIGHTS`` is set. A
  configured file that does not exist raises.
* :func:`merge_state_dict` is the JAX ``merge_variables`` on state dicts
  (strict=False semantics): a source tensor with no counterpart in the
  target is skipped and reported, a shape mismatch raises. As the JAX
  converter does, ``num_batches_tracked`` and ``relative_position_index``
  (a constant table) are not taken from the source.
* a source is a ``.pth`` file: a state dict under the reference's names
  (the port's), unwrapped from ``best_state_dict`` or ``state_dict`` with
  a ``module.`` prefix stripped (``convert/torch_import.py:32-45``), which
  covers the port's own ``final_state.pth``, ``model_best.pth`` and epoch
  checkpoints. The JAX package's Orbax directories are not read here.
* :func:`freeze` is ``frozen_predicate_for_cfg`` as ``requires_grad_(False)``:
  ``SINGLEFORMER_FIX`` freezes the whole first stage, ``BACKBONE_FIX`` the
  HRNet trunk (the vanilla model's, or a TransPose-H first stage's: the JAX
  predicate matches the ``trunk``/``backbone`` subtrees, and the HRFormer
  first stage has neither). The trainer keeps frozen parameters out of the
  optimizer; BatchNorm statistics of frozen modules still update in
  training unless ``DEVICE.FROZEN_STAGE_EVAL_MODE`` runs the frozen first
  stage in eval mode (``models/interformer.py``).
"""

from __future__ import annotations

import logging
import os
import re
from typing import Dict, List, Tuple

import torch
from torch import nn

from i2rnet_tpu_torch.models.hrnet import HRNetTrunk

logger = logging.getLogger(__name__)

#: state-dict entries the JAX converter does not take from a source
NOT_LOADED = ("num_batches_tracked", "relative_position_index")
#: the HRNet trunk's children (``HRStem``, then transitions and stages 2-3)
TRUNK = ("conv1", "bn1", "conv2", "bn2", "layer1", "transition1", "stage2", "transition2",
         "stage3")


def load_source(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of the ``.pth`` at ``path`` (unwrapped, ``module.``
    stripped)."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an Orbax checkpoint of the JAX package); "
                         "the port reads .pth files")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "best_state_dict" in obj:
        obj = obj["best_state_dict"]
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {re.sub(r"^module\.", "", k): v for k, v in obj.items()}


def merge_state_dict(module: nn.Module, src: Dict[str, torch.Tensor]) -> Tuple[int, List[str]]:
    """Copy ``src`` into ``module``'s parameters and buffers in place:
    (tensors loaded, source names skipped). A shape mismatch raises
    ``ValueError`` before anything is copied."""
    dst = module.state_dict(keep_vars=True)
    plan, skipped = [], []
    for name, value in src.items():
        if name.endswith(NOT_LOADED):
            continue
        if name not in dst:
            skipped.append(name)
            continue
        if tuple(dst[name].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint {tuple(value.shape)} vs "
                             f"model {tuple(dst[name].shape)}")
        plan.append((dst[name], value))
    with torch.no_grad():
        for target, value in plan:
            target.copy_(value.to(target.dtype))
    return len(plan), skipped


def _graft(module: nn.Module, path: str, what: str) -> None:
    n, skipped = merge_state_dict(module, load_source(path))
    logger.info("=> %s: loaded %d tensors%s", what, n,
                f", skipped {len(skipped)} (e.g. {skipped[:3]})" if skipped else "")


def _check(path: str, key: str) -> None:
    if path and not (os.path.isfile(path) or os.path.isdir(path)):
        raise ValueError(f"MODEL.{key} = {path!r} does not exist")


def load_pretrained(cfg: Dict, model: nn.Module) -> nn.Module:
    """Apply the JAX ``load_pretrained`` dispatch to a freshly initialised
    ``model`` (changed in place; also returned)."""
    m = cfg["MODEL"]
    single_model, pretrained = m.get("SINGLE_MODEL", ""), m.get("PRETRAINED", "")
    if m.get("SINGLEFORMER"):
        end2end = m.get("END2END", False)
        if not end2end and not single_model:
            # the reference loads the intra checkpoint unconditionally;
            # training from a random first stage is almost never intended
            logger.warning("two-stage training without MODEL.SINGLE_MODEL: the %s first "
                           "stage starts from RANDOM weights", m["SINGLEFORMER"])
        if not end2end and single_model:
            _check(single_model, "SINGLE_MODEL")
            _graft(model.singleformer, single_model,
                   f"two-stage intra checkpoint {single_model} into singleformer/")
        elif end2end and pretrained:
            _check(pretrained, "PRETRAINED")
            _graft(model.singleformer, pretrained,
                   f"e2e backbone init {pretrained} into singleformer/")
    elif m.get("INIT_WEIGHTS", True) and pretrained:
        _check(pretrained, "PRETRAINED")
        _graft(model, pretrained, f"backbone init {pretrained}")
    return model


def frozen_names(cfg: Dict, model: nn.Module) -> List[str]:
    """The parameters ``SINGLEFORMER_FIX`` and ``BACKBONE_FIX`` freeze."""
    m = cfg["MODEL"]
    freeze_single = bool(m.get("SINGLEFORMER_FIX") and m.get("SINGLEFORMER"))
    trunks = []
    if m.get("BACKBONE_FIX"):
        if isinstance(model, HRNetTrunk):
            trunks.append("")
        if isinstance(getattr(model, "singleformer", None), HRNetTrunk):
            trunks.append("singleformer.")
    names = []
    for name, _ in model.named_parameters():
        if freeze_single and name.startswith("singleformer."):
            names.append(name)
        elif any(name.startswith(t) and name[len(t):].split(".", 1)[0] in TRUNK
                 for t in trunks):
            names.append(name)
    return names


def freeze(cfg: Dict, model: nn.Module) -> List[str]:
    """``requires_grad_(False)`` on :func:`frozen_names`; returns them."""
    names = frozen_names(cfg, model)
    params = dict(model.named_parameters())
    for name in names:
        params[name].requires_grad_(False)
    if names:
        logger.info("=> froze %d parameter tensors (SINGLEFORMER_FIX %s, BACKBONE_FIX %s)",
                    len(names), cfg["MODEL"].get("SINGLEFORMER_FIX"),
                    cfg["MODEL"].get("BACKBONE_FIX"))
    return names


def load_model_file(path: str, model: nn.Module) -> nn.Module:
    """``TEST.MODEL_FILE``: every parameter and buffer of ``model`` from the
    ``.pth`` at ``path`` (a reference checkpoint, or the port's
    ``final_state.pth``, ``model_best.pth`` or an epoch checkpoint). Source
    tensors the model lacks are reported; a tensor the file lacks raises."""
    if not os.path.isfile(path):
        raise FileNotFoundError(f"model file {path!r} does not exist")
    src = load_source(path)
    missing = [k for k in model.state_dict() if k not in src and not k.endswith(NOT_LOADED)]
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} tensors of the model "
                         f"(e.g. {missing[:3]})")
    n, skipped = merge_state_dict(model, src)
    if skipped:
        logger.warning("%s: %d tensors the model does not have (e.g. %s)", path, len(skipped),
                       skipped[:3])
    logger.info("=> loaded %d tensors from %s", n, path)
    return model

