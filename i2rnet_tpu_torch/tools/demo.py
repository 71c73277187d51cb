"""Single-image demo: ``python3 -m i2rnet_tpu_torch.tools.demo --image img.jpg``.

Port of ``tools/demo.py`` of the JAX package (the reference ``demo.ipynb``
as a script): one image and its person boxes (or the whole image) served
through :class:`~i2rnet_tpu_torch.serving.Predictor`, the keypoints printed
and each skeleton drawn (``utils.vis.draw_skeleton``) into ``--out``.

    python3 -m i2rnet_tpu_torch.tools.demo --image img.jpg \\
        [--boxes x,y,w,h [x,y,w,h ...]] [--cfg experiment.yaml] \\
        [--checkpoint model.pth] [--out demo_out.jpg] [--device cuda|cpu]

The model is ``--cfg``'s (the COCO W48 preset without one) with the weights
of ``--checkpoint``. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
from PIL import Image


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="I2R-Net single-image demo (PyTorch/CUDA)")
    p.add_argument("--image", required=True)
    p.add_argument("--boxes", nargs="*", default=None,
                   help="person boxes as x,y,w,h (default: the whole image)")
    p.add_argument("--cfg", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--out", default="demo_out.jpg")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p.parse_args(argv)


def predictor(args, n: int, image_hw):
    """A predictor over ``--cfg``'s model holding the image and its ``n``
    boxes in one call."""
    from i2rnet_tpu_torch.core.pretrained import load_model_file
    from i2rnet_tpu_torch.registry import get_dataset_class, get_model_builder
    from i2rnet_tpu_torch.serving import Predictor

    if args.cfg:
        from i2rnet_tpu_torch.config.config import load_config, to_port
        cfg = to_port(load_config(args.cfg))
    else:
        from i2rnet_tpu_torch.presets import w48_pure_en6
        cfg = w48_pure_en6("coco")
    model = get_model_builder(cfg["MODEL"]["NAME"])(cfg, device=args.device)
    if args.checkpoint:
        load_model_file(args.checkpoint, model)
    else:
        print("warning: no checkpoint -- random weights (demo plumbing only)")
    k = int(cfg["MODEL"]["NUM_JOINTS"])
    pairs = [p for p in get_dataset_class(cfg["DATASET"]["DATASET"]).flip_pairs
             if p[0] < k and p[1] < k]
    return Predictor(model, cfg, pairs, batch_images=1, n_buckets=(n,), raw_hw=image_hw)


def main(argv: Optional[List[str]] = None):
    """Run the demo; returns the keypoints ``[n, K, 3]`` in source pixels."""
    from i2rnet_tpu_torch.data.jpeg import imread
    from i2rnet_tpu_torch.utils.vis import draw_skeleton

    args = parse_args(argv)
    img = imread(args.image, rgb=True)
    src_h, src_w = img.shape[:2]
    boxes = ([list(map(float, b.split(","))) for b in args.boxes]
             if args.boxes else [[0.0, 0.0, float(src_w), float(src_h)]])
    keypoints = predictor(args, len(boxes), (src_h, src_w)).predict([img], [boxes])[0]
    out = img
    for kp in keypoints:  # random weights draw every joint
        out = draw_skeleton(out, kp, conf_thresh=0.2 if args.checkpoint else 0.0)
    Image.fromarray(out).save(args.out)
    print(f"wrote {args.out}; keypoints (x, y, confidence):\n{keypoints}")
    return keypoints


if __name__ == "__main__":
    main(sys.argv[1:])
