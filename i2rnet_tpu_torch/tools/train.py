"""Train a recipe: ``python3 -m i2rnet_tpu_torch.tools.train --cfg <yaml> [opts ...]``.

Port of ``tools/train.py`` of the JAX package on one device: the recipe's
YAML through ``config.load_config`` (``--dataDir``, ``--modelDir``,
``--logDir`` and the trailing ``KEY value`` overrides as there), ``--seed``
in place of ``SEED``, the logger and output layout of ``create_logger``,
then ``core.trainer.train_loop`` (``--max-epochs``,
``--max-steps-per-epoch``). It trains on the card unless ``--device cpu``
is given. The multi-host flags (``--coordinator``, ``--num-processes``,
``--process-id``) wait for data parallelism and raise.

    python3 -m i2rnet_tpu_torch.tools.train \\
        --cfg experiments/coco/interformer_coco_hrt_192_p2_b12.yaml \\
        --max-epochs 1 DATASET.ROOT data/coco MODEL.SINGLE_MODEL first_stage.pth
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional

from i2rnet_tpu_torch.config.config import load_config, to_port
from i2rnet_tpu_torch.core.trainer import train_loop
from i2rnet_tpu_torch.utils.logging import create_logger


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train I2R-Net (PyTorch/CUDA)")
    p.add_argument("--cfg", required=True, help="experiment YAML (reference schema)")
    p.add_argument("--modelDir", default="", type=str)
    p.add_argument("--logDir", default="", type=str)
    p.add_argument("--dataDir", default="", type=str)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--coordinator", default="", type=str,
                   help="multi-host training is not ported; raises when given")
    p.add_argument("--num-processes", default=1, type=int)
    p.add_argument("--process-id", default=0, type=int)
    p.add_argument("--max-epochs", default=None, type=int)
    p.add_argument("--max-steps-per-epoch", default=None, type=int)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def load_cfg(args):
    """The port config of ``--cfg`` with the overrides and directories."""
    return to_port(load_config(args.cfg, opts=args.opts or [], data_dir=args.dataDir,
                               model_dir=args.modelDir, log_dir=args.logDir))


def main(argv: Optional[List[str]] = None, on_step: Optional[Callable] = None):
    """Train as the arguments say: (the final TrainState, the output dir).
    ``on_step`` is handed to ``train_loop`` (each step's metrics and host
    times)."""
    args = parse_args(argv)
    if args.coordinator or args.num_processes != 1 or args.process_id != 0:
        raise NotImplementedError("multi-host training (--coordinator, --num-processes, "
                                  "--process-id) is not ported")
    cfg = load_cfg(args)
    if args.seed is not None:
        cfg["SEED"] = args.seed
    logger, output_dir, _ = create_logger(cfg, args.cfg, "train")
    logger.info("config: %s", cfg)
    state = train_loop(cfg, output_dir, max_epochs=args.max_epochs,
                       max_steps_per_epoch=args.max_steps_per_epoch, device=args.device,
                       on_step=on_step)
    return state, output_dir


if __name__ == "__main__":
    main(sys.argv[1:])
