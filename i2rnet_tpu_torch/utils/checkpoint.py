"""Checkpoints with the reference's logical contents, through ``torch.save``.

Port of ``i2rnet_tpu/utils/checkpoint.py`` (reference ``tools/ddp_train.py:
244-263``, ``lib/utils/utils.py:105-110``): every epoch writes
``checkpoint/epoch_{N}.pth`` holding ``epoch``, ``perf``, ``state_dict`` (the
model's, under the reference's names), ``optimizer``, ``step`` and ``meta``;
``model_best.pth`` on a new best; ``final_state.pth`` at the end. The newest
epoch is what ``AUTO_RESUME`` loads.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import torch

_EPOCH = re.compile(r"epoch_(\d+)\.pth")


def _state_dict(model):
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(output_dir: str, epoch: int, state, perf: float, is_best: bool,
                    model_name: str = "", train_global_steps: int = 0,
                    valid_global_steps: int = 0, keep: int = 3) -> Path:
    """Write ``checkpoint/epoch_{epoch}.pth`` (and ``model_best.pth`` when
    ``is_best``); keep the newest ``keep`` epochs. Returns the path."""
    out = Path(output_dir)
    (out / "checkpoint").mkdir(parents=True, exist_ok=True)
    sd = _state_dict(state.model)
    payload = {
        "epoch": int(epoch),
        "perf": float(perf),
        "state_dict": sd,
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        "meta": {"model": model_name, "train_global_steps": int(train_global_steps),
                 "valid_global_steps": int(valid_global_steps)},
    }
    path = out / "checkpoint" / f"epoch_{epoch}.pth"
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)
    if is_best:
        torch.save({"state_dict": sd}, out / "model_best.pth")
    for e in sorted(_epochs(out))[:-keep]:
        (out / "checkpoint" / f"epoch_{e}.pth").unlink(missing_ok=True)
    return path


def _epochs(out: Path):
    d = out / "checkpoint"
    if not d.exists():
        return []
    return [int(m.group(1)) for p in d.iterdir() if (m := _EPOCH.fullmatch(p.name))]


def latest_checkpoint(output_dir: str) -> Optional[str]:
    """The newest ``checkpoint/epoch_{N}.pth`` under ``output_dir``, or None."""
    eps = _epochs(Path(output_dir))
    if not eps:
        return None
    return os.fspath(Path(output_dir) / "checkpoint" / f"epoch_{max(eps)}.pth")


def load_checkpoint(path: str, map_location="cpu"):
    """A checkpoint's payload (tensors on ``map_location``)."""
    return torch.load(path, map_location=map_location, weights_only=True)


def save_final_state(output_dir: str, state) -> Path:
    """``final_state.pth``: the model's state dict."""
    path = Path(output_dir) / "final_state.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": _state_dict(state.model)}, path)
    return path
