"""Train a recipe: ``python3 -m i2rnet_tpu_torch.tools.train --cfg <yaml> [opts ...]``.

Port of ``tools/train.py`` of the JAX package: the recipe's YAML through
``config.load_config`` (``--dataDir``, ``--modelDir``, ``--logDir`` and the
trailing ``KEY value`` overrides as there), ``--seed`` in place of ``SEED``,
the logger and output layout of ``create_logger``, then
``core.trainer.train_loop`` (``--max-epochs``, ``--max-steps-per-epoch``).
It trains on the card unless ``--device cpu`` is given. The recipe's ``CUDNN``
block sets ``torch.backends.cudnn`` (``benchmark``, ``deterministic``,
``enabled``) before the model is built, as the reference's entry points do
(``config.apply_cudnn``; ``tools/test.py`` likewise).

Data parallelism: under ``torchrun`` (its ``RANK``/``WORLD_SIZE`` environment)
or with the JAX CLI's ``--coordinator host:port --num-processes N
--process-id I`` each process is one rank on its own card
(``LOCAL_RANK``'s), ``nccl`` on CUDA and ``gloo`` on the CPU
(``--backend gloo`` on CUDA too); only rank 0 logs and writes checkpoints.

    python3 -m i2rnet_tpu_torch.tools.train \\
        --cfg experiments/coco/interformer_coco_hrt_192_p2_b12.yaml \\
        --max-epochs 1 DATASET.ROOT data/coco MODEL.SINGLE_MODEL first_stage.pth
    python3 -m torch.distributed.run --nproc_per_node 2 -m i2rnet_tpu_torch.tools.train \\
        --cfg experiments/coco/interformer_coco_w48_pure_en6.yaml
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, List, Optional

from i2rnet_tpu_torch.config.config import apply_cudnn, load_config, to_port
from i2rnet_tpu_torch.core.trainer import train_loop
from i2rnet_tpu_torch.parallel import dist
from i2rnet_tpu_torch.utils.logging import create_logger


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Train I2R-Net (PyTorch/CUDA)")
    p.add_argument("--cfg", required=True, help="experiment YAML (reference schema)")
    p.add_argument("--modelDir", default="", type=str)
    p.add_argument("--logDir", default="", type=str)
    p.add_argument("--dataDir", default="", type=str)
    p.add_argument("--seed", default=None, type=int)
    add_dist_args(p)
    p.add_argument("--max-epochs", default=None, type=int)
    p.add_argument("--max-steps-per-epoch", default=None, type=int)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def add_dist_args(p) -> None:
    """The flags of data parallelism and the device, shared with ``tools/test.py``."""
    p.add_argument("--coordinator", default="", type=str,
                   help="host:port of rank 0's rendezvous (else torchrun's environment)")
    p.add_argument("--num-processes", default=None, type=int)
    p.add_argument("--process-id", default=None, type=int)
    p.add_argument("--backend", default=None, choices=dist.BACKENDS,
                   help="nccl on CUDA and gloo on the CPU unless given")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")


def start(args):
    """The process group of the arguments or torchrun's environment, where
    there is one; returns this rank's device."""
    dist.init(args.coordinator, args.num_processes, args.process_id, args.backend, args.device)
    return str(dist.local_device(args.device, dist.rank()))


def load_cfg(args):
    """The port config of ``--cfg`` with the overrides and directories."""
    return to_port(load_config(args.cfg, opts=args.opts or [], data_dir=args.dataDir,
                               model_dir=args.modelDir, log_dir=args.logDir))


def main(argv: Optional[List[str]] = None, on_step: Optional[Callable] = None):
    """Train as the arguments say: (the final TrainState, the output dir).
    ``on_step`` is handed to ``train_loop`` (each step's metrics and host
    times)."""
    args = parse_args(argv)
    device = start(args)
    cfg = load_cfg(args)
    if args.seed is not None:
        cfg["SEED"] = args.seed
    logger, output_dir, _ = create_logger(cfg, args.cfg, "train", rank=dist.rank())
    logger.info("config: %s", cfg)
    logger.info("cudnn: %s", apply_cudnn(cfg))
    state = train_loop(cfg, output_dir, max_epochs=args.max_epochs,
                       max_steps_per_epoch=args.max_steps_per_epoch, device=device,
                       on_step=on_step)
    return state, output_dir


if __name__ == "__main__":
    main(sys.argv[1:])
