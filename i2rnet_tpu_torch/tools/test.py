"""Evaluate a recipe: ``python3 -m i2rnet_tpu_torch.tools.test --cfg <yaml> [opts ...]``.

Port of ``tools/test.py`` of the JAX package on one device: the config as
``tools/train.py`` reads it, the model of ``MODEL.NAME`` with the weights
of ``TEST.MODEL_FILE`` (a ``.pth`` under the reference's names, or a
checkpoint the port wrote), or of ``final_state.pth`` in the output
directory when that is empty; then ``core.validate.validate`` on the
dataset's ``TEST_SET`` (``--max-batches`` stops early) and the metric
table in the log. It runs on the card unless ``--device cpu`` is given;
across processes as ``tools/train.py`` (``torchrun``, or ``--coordinator
--num-processes --process-id``), every rank scoring the gathered results.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from i2rnet_tpu_torch.config.config import apply_cudnn
from i2rnet_tpu_torch.core.pretrained import load_model_file
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.registry import get_dataset_class, get_model_builder
from i2rnet_tpu_torch.parallel import dist
from i2rnet_tpu_torch.tools.train import add_dist_args, load_cfg, start
from i2rnet_tpu_torch.utils.logging import create_logger, metric_table


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Evaluate I2R-Net (PyTorch/CUDA)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--modelDir", default="", type=str)
    p.add_argument("--logDir", default="", type=str)
    p.add_argument("--dataDir", default="", type=str)
    p.add_argument("--max-batches", default=None, type=int)
    add_dist_args(p)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Evaluate as the arguments say: (name_value, perf)."""
    args = parse_args(argv)
    device = start(args)
    cfg = load_cfg(args)
    logger, output_dir, _ = create_logger(cfg, args.cfg, "valid", rank=dist.rank())
    logger.info("cudnn: %s", apply_cudnn(cfg))

    model = get_model_builder(cfg["MODEL"]["NAME"])(cfg, device=device)
    model_file = cfg["TEST"]["MODEL_FILE"] or str(Path(output_dir) / "final_state.pth")
    load_model_file(model_file, model)
    logger.info("=> loaded %s", model_file)

    d = cfg["DATASET"]
    dataset = get_dataset_class(d["DATASET"])(cfg, d["ROOT"], d["TEST_SET"], is_train=False)
    name_value, perf = validate(cfg, dataset, model, output_dir, device=device,
                                max_batches=args.max_batches)
    logger.info("\n%s", metric_table(name_value, cfg["MODEL"]["NAME"]))
    logger.info("perf: %.4f", perf)
    return name_value, perf


if __name__ == "__main__":
    main(sys.argv[1:])
