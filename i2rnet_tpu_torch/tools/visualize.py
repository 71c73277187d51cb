"""Attention maps of a model on one image: ``python3 -m i2rnet_tpu_torch.tools.visualize``.

Port of ``tools/visualize.py`` of the JAX package (reference
``visualize.py``): the image resized to the model's input, one forward, and
the softmax weights of every transformer encoder layer recorded
(:class:`AttentionRecorder`); for each joint, the tokens that the location
of its heatmap peak attends to in the recorded layer (``--layer``, the last
by default), averaged over heads, drawn in cv2's JET colours over the crop.
The panels (the crop, then one per joint) go into a grid of six columns.

Softmax weights exist only in the plain attention: while recording, every
encoder layer's attention runs Kernel A's plain version (the JAX tool
builds its model with ``use_pallas=False`` for the same reason). The rest
of the forward keeps its kernels. This is an inspection tool, not a path
that serves or trains.

    python3 -m i2rnet_tpu_torch.tools.visualize --cfg <yaml> --image <path> \\
        [--out attention_vis.jpg] [--layer -1] [--device cuda] [opts ...]
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from i2rnet_tpu_torch.data.jpeg import imread
from i2rnet_tpu_torch.data.resize import resize_linear
from i2rnet_tpu_torch.models import encoder
from i2rnet_tpu_torch.ops.cuda.mhsa import NEG_INF, masked_mhsa_torch
from i2rnet_tpu_torch.tools.compute_flops import build
from i2rnet_tpu_torch.config.config import load_config, to_port
from i2rnet_tpu_torch.utils.vis import JET, JPEG_QUALITY

NCOL = 6


class AttentionRecorder:
    """Inside, every encoder layer's eval attention runs Kernel A's plain
    version, and its softmax weights ``[B, H, S, S]`` (f32 numpy) are
    appended to :attr:`records`, layer after layer."""

    def __init__(self):
        self.records: List[np.ndarray] = []

    def __enter__(self):
        self._kept = encoder.masked_mhsa

        def recorded(q, k, v, num_heads, key_padding_mask=None, use_kernel=False):
            b, s, c = q.shape
            d = c // num_heads

            def heads(x):
                return x.reshape(b, s, num_heads, d).transpose(1, 2).float()

            logits = torch.matmul(heads(q) * (1.0 / d ** 0.5), heads(k).transpose(-1, -2))
            if key_padding_mask is not None:
                logits = logits.masked_fill(key_padding_mask[:, None, None, :], NEG_INF)
            self.records.append(torch.softmax(logits, dim=-1).cpu().numpy())
            return masked_mhsa_torch(q, k, v, num_heads, key_padding_mask)

        encoder.masked_mhsa = recorded
        return self

    def __exit__(self, *exc):
        encoder.masked_mhsa = self._kept
        return False


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description="Attention maps of I2R-Net on one image. While recording, each encoder "
                    "layer's attention runs Kernel A's plain version (softmax weights exist "
                    "only there); the rest of the forward keeps its kernels.")
    p.add_argument("--cfg", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--out", default="attention_vis.jpg")
    p.add_argument("--layer", type=int, default=-1)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def attention_grid(crop: np.ndarray, heat: np.ndarray, attn: np.ndarray,
                   token_grid) -> np.ndarray:
    """The RGB grid: ``crop`` (uint8 [h, w, 3]), then per joint of ``heat``
    ``[K, hh, hw]`` the attention row ``attn`` ``[B, H, S, S]`` of the token
    under the joint's peak, over ``token_grid`` (gh, gw), blended 0.6 / 0.4."""
    h, w = crop.shape[:2]
    gh, gw = token_grid
    panels = [crop]
    for hm in heat:
        y, x = np.unravel_index(hm.argmax(), hm.shape)
        ty = min(int(y * gh / hm.shape[0]), gh - 1)
        tx = min(int(x * gw / hm.shape[1]), gw - 1)
        dep = attn[0, :, ty * gw + tx, :].mean(0)[:gh * gw].reshape(gh, gw)
        dep = (dep / max(dep.max(), 1e-9) * 255).astype(np.uint8)
        panels.append((0.6 * JET[resize_linear(dep, (w, h))] + 0.4 * crop).astype(np.uint8))
    nrow = (len(panels) + NCOL - 1) // NCOL
    grid = np.zeros((nrow * h, NCOL * w, 3), np.uint8)
    for i, panel in enumerate(panels):
        r, c = divmod(i, NCOL)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = panel
    return grid


def main(argv: Optional[List[str]] = None):
    """Record and draw as the arguments say: (the recorded weights, the grid)."""
    args = parse_args(argv)
    cfg = to_port(load_config(args.cfg, opts=args.opts or []))
    device = torch.device(args.device)
    model = build(cfg, device)
    w, h = cfg["MODEL"]["IMAGE_SIZE"]
    crop = resize_linear(imread(args.image, rgb=True), (w, h)).astype(np.float32) / 255.0
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg["DEVICE"]["COMPUTE_DTYPE"]]
    images = torch.from_numpy(crop)[None, None].to(device, dt)
    pos = torch.ones(1, 1, h, w, 1, device=device, dtype=dt)
    valid = torch.ones(1, 1, dtype=torch.bool, device=device)
    with AttentionRecorder() as rec, torch.inference_mode():
        out = model(images, pos, valid)
    heat = (out["multi"] if isinstance(out, dict) else out)[0, 0].float().cpu().numpy()
    attn = rec.records[args.layer]
    th, tw = cfg["MODEL"]["TRANS_SIZE"]
    s = attn.shape[-1]
    grid_hw = (th, tw) if s % (th * tw) == 0 else (h // 4, w // 4)
    grid = attention_grid((crop * 255).astype(np.uint8), heat, attn, grid_hw)
    Image.fromarray(grid).save(args.out, quality=JPEG_QUALITY)
    print(f"wrote {args.out} ({len(rec.records)} attention layers recorded)")
    return rec.records, grid


if __name__ == "__main__":
    main(sys.argv[1:])
