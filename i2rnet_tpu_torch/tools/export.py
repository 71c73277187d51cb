"""Export a trained model as a serving artifact: ``python3 -m i2rnet_tpu_torch.tools.export``.

Port of ``tools/export.py`` of the JAX package. The artifact (``.i2rx``, see
:mod:`i2rnet_tpu_torch.serving`) holds per person bucket the whole request
program (crop-warp and position masks, forward and flip-test forward, DARK
decode to source pixels) with the weights, as ``torch.export`` programs
that call the hand kernels as ``i2r::`` ops; ``serving.load_predictor``
serves it in a process with ``torch``, ``numpy`` and this package only.

    python3 -m i2rnet_tpu_torch.tools.export --cfg experiments/coco/....yaml \\
        --checkpoint model.pth --out model.i2rx [--batch 8] [--persons 2 4 7] \\
        [--raw-hw 480 640] [--device cuda|cpu] [--no-kernels] [--selftest]

It exports on the card unless ``--device cpu`` is given; an artifact serves
on the device it was exported for.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Export an I2R-Net serving artifact (PyTorch/CUDA)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="a .pth under the reference's names or one this port wrote "
                        "(Orbax directories are not read: the port has no JAX); the "
                        "builder's random weights if omitted (plumbing checks only)")
    p.add_argument("--out", required=True)
    p.add_argument("--batch", type=int, default=None,
                   help="images per call (default TEST.BATCH_SIZE_PER_GPU)")
    p.add_argument("--persons", type=int, nargs="+", default=None,
                   help="person bucket(s) N; several values (e.g. 2 4 7) put one program "
                        "per bucket in the artifact and predict() routes rows to the "
                        "smallest fit (default DATASET.MAX_PATCH)")
    p.add_argument("--raw-hw", type=int, nargs=2, default=None,
                   help="static raw-image canvas H W (default DEVICE.MAX_IMAGE_HW)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the artifact serves on (default cuda)")
    p.add_argument("--no-kernels", action="store_true",
                   help="export plain PyTorch only, without the hand kernels' ops")
    p.add_argument("--selftest", action="store_true",
                   help="load the written artifact and serve one request")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Export as the arguments say; returns the header written."""
    from i2rnet_tpu_torch.config.config import load_config, to_port
    from i2rnet_tpu_torch.core.pretrained import load_model_file
    from i2rnet_tpu_torch.registry import get_model_builder
    from i2rnet_tpu_torch.serving import export_predictor, load_predictor, save_artifact

    args = parse_args(argv)
    cfg = to_port(load_config(args.cfg))
    b = args.batch or int(cfg["TEST"]["BATCH_SIZE_PER_GPU"])
    persons = args.persons or [int(cfg["DATASET"]["MAX_PATCH"])]
    raw_hw = tuple(args.raw_hw or cfg["DEVICE"]["MAX_IMAGE_HW"])
    model = get_model_builder(cfg["MODEL"]["NAME"])(cfg, device=args.device)
    if args.checkpoint:
        load_model_file(args.checkpoint, model)
    else:
        print("warning: no checkpoint -- exporting the builder's random weights")
    payload, header = export_predictor(cfg, model, b, persons, raw_hw, device=args.device,
                                       use_kernels=False if args.no_kernels else None)
    save_artifact(args.out, payload, header)
    print(f"wrote {args.out}: {len(payload) / 1e6:.1f} MB payload, header {header}")

    if args.selftest:
        pred = load_predictor(args.out, device=args.device)
        rng = np.random.RandomState(0)
        img = rng.randint(0, 256, (raw_hw[0] // 2, raw_hw[1] // 2, 3)).astype(np.uint8)
        out = pred.predict([img], [[[4, 4, 40, 80]]])
        print(f"selftest ok: keypoints {out[0].shape}, conf range "
              f"[{out[0][..., 2].min():.3f}, {out[0][..., 2].max():.3f}]")
    return header


if __name__ == "__main__":
    main(sys.argv[1:])
