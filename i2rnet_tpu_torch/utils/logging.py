"""The entry points' logger, output layout and metric table.

Port of ``i2rnet_tpu/utils/logging.py`` (reference ``lib/utils/utils.py:
24-83``): outputs under ``OUTPUT_DIR/{dataset}/{model}/{cfg_name}``, the log
file ``GT_{USE_GT_BBOX}_{phase}_{cfg_name}_{time}.log`` under
``LOG_DIR/{dataset}/{model}``, both relative to the working directory as in
the reference; ``metric_table`` replaces the reference's pylsytable.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Dict


def create_logger(cfg: Dict, cfg_name: str, phase: str = "train", rank: int = 0):
    """(logger, final output dir, tensorboard log dir) of the port config
    ``cfg`` (``config.to_port``'s, which carries ``OUTPUT_DIR`` and
    ``LOG_DIR``). The logger is the port's root logger, ``i2rnet_tpu_torch``."""
    root_output = Path(cfg.get("OUTPUT_DIR") or "output")
    dataset = cfg["DATASET"]["DATASET"]
    model = cfg["MODEL"]["NAME"]
    cfg_name = os.path.basename(cfg_name).split(".")[0]

    final_output_dir = root_output / dataset / model / cfg_name
    final_output_dir.mkdir(parents=True, exist_ok=True)

    time_str = time.strftime("%Y-%m-%d-%H-%M")
    log_file = f"GT_{cfg['TEST']['USE_GT_BBOX']}_{phase}_{cfg_name}_{time_str}.log"
    log_dir = Path(cfg.get("LOG_DIR") or "log") / dataset / model
    log_dir.mkdir(parents=True, exist_ok=True)

    logger = logging.getLogger("i2rnet_tpu_torch")
    logger.setLevel(logging.INFO)
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)-15s %(message)s")
    if rank == 0:
        fh = logging.FileHandler(log_dir / log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
        ch = logging.StreamHandler()
        ch.setFormatter(fmt)
        logger.addHandler(ch)

    tb_log_dir = log_dir / (cfg_name + "_" + time_str)
    return logger, str(final_output_dir), str(tb_log_dir)


def metric_table(name_values, model_name: str) -> str:
    """The metrics as a table (reference ``lib/core/function.py:470-478``)."""
    names = list(name_values.keys())
    vals = [f"{v:.4f}" if isinstance(v, float) else str(v) for v in name_values.values()]
    widths = [max(len(n), len(v)) for n, v in zip(names, vals)]
    head = " | ".join(n.ljust(w) for n, w in zip(names, widths))
    row = " | ".join(v.ljust(w) for v, w in zip(vals, widths))
    sep = "-+-".join("-" * w for w in widths)
    return f"[{model_name}]\n{head}\n{sep}\n{row}"
