"""Reproduce a published AP row: ``python3 -m i2rnet_tpu_torch.tools.reproduce``.

Port of ``tools/reproduce.py`` of the JAX package, with its flags and exit
codes. Once the datasets and released checkpoints are at hand, the parity
run against the published tables (reference ``README.md:14-39``,
BASELINE.md) is one command:

    python3 -m i2rnet_tpu_torch.tools.reproduce \\
        --cfg experiments/crowdpose/interformer_crowdpose_hrt_192_p4_b4.yaml \\
        --checkpoint models/interformer/crowdpose/interformer_crowdpose_hrt_192_p4_b4.pth \\
        --root /data/crowdpose/

It loads the checkpoint directly (a released ``.pth`` or a checkpoint the
port wrote: the state-dict names are the reference's, so nothing is
converted), evaluates it with ``core.validate.validate`` on the card (or
``--device cpu``), prints the metric row in BASELINE.md's format, and diffs
each metric against the published expectation for the config (within
``--tol``, default 0.001, the "AP parity within 0.1 points" target in
absolute AP). Exit code 0 when every expected metric is within tolerance, 1
when one is not, 2 without a checkpoint.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from i2rnet_tpu_torch.core.pretrained import load_model_file
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.registry import get_dataset_class, get_model_builder
from i2rnet_tpu_torch.config.config import load_config, to_port
from i2rnet_tpu_torch.utils.logging import create_logger

#: the published tables (reference README.md:14-39; BASELINE.md), by the
#: config file's stem (``tools/reproduce.py`` of the JAX package)
EXPECTED = {
    "interformer_crowdpose_w48_pure_en6": {
        "AP": 0.723, "Ap .5": 0.924, "AP .75": 0.779,
        "AR": 0.765, "AR .5": 0.932, "AR .75": 0.819,
        "AP (easy)": 0.799, "AP (medium)": 0.732, "AP (hard)": 0.628},
    "interformer_crowdpose_tph_192_p6_b4": {
        "AP": 0.763, "Ap .5": 0.935, "AP .75": 0.822,
        "AR": 0.791, "AR .5": 0.940, "AR .75": 0.844,
        "AP (easy)": 0.832, "AP (medium)": 0.770, "AP (hard)": 0.674},
    "interformer_crowdpose_hrt_192_p4_b4": {
        "AP": 0.774, "Ap .5": 0.936, "AP .75": 0.833,
        "AR": 0.803, "AR .5": 0.945, "AR .75": 0.855,
        "AP (easy)": 0.838, "AP (medium)": 0.781, "AP (hard)": 0.693},
    "interformer_ochuman_w48_pure_en6": {
        "AP": 0.643, "Ap .5": 0.850, "AP .75": 0.692},
    "interformer_ochuman_tph_192_p3_b8": {
        "AP": 0.665, "Ap .5": 0.838, "AP .75": 0.714},
    "interformer_ochuman_hrt_192_p3_b8": {
        "AP": 0.678, "Ap .5": 0.850, "AP .75": 0.728},
    "interformer_coco_w48_pure_en6": {
        "AP": 0.753, "Ap .5": 0.902, "AP .75": 0.819, "AP (M)": 0.717,
        "AP (L)": 0.824, "AR": 0.805, "AR (M)": 0.761, "AR (L)": 0.868},
    "interformer_coco_tph_192_p4_b4": {
        "AP": 0.758, "Ap .5": 0.904, "AP .75": 0.821, "AP (M)": 0.720,
        "AP (L)": 0.829, "AR": 0.809, "AR (M)": 0.766, "AR (L)": 0.873},
    "interformer_coco_hrt_192_p2_b12": {
        "AP": 0.764, "Ap .5": 0.908, "AP .75": 0.832, "AP (M)": 0.723,
        "AP (L)": 0.837, "AR": 0.814, "AR (M)": 0.769, "AR (L)": 0.881},
    "interformer_coco_hrt_288_p2_b4": {
        "AP": 0.773, "Ap .5": 0.910, "AP .75": 0.836, "AP (M)": 0.730,
        "AP (L)": 0.845, "AR": 0.821, "AR (M)": 0.777, "AR (L)": 0.886},
}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Reproduce a published AP row and diff against it")
    p.add_argument("--cfg", required=True)
    p.add_argument("--checkpoint", default="",
                   help=".pth (released or the port's); default TEST.MODEL_FILE")
    p.add_argument("--root", default="", help="override DATASET.ROOT")
    p.add_argument("--tol", default=0.001, type=float,
                   help="absolute AP tolerance (0.001 = 0.1 AP points)")
    p.add_argument("--expected", default="",
                   help="override expectations, e.g. 'AP=0.774,AR=0.803'; default looks up the "
                        "config basename in the published tables")
    p.add_argument("--max-batches", default=None, type=int)
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=None)
    return p.parse_args(argv)


def run(args) -> int:
    """Evaluate and diff; the exit code."""
    args.opts = list(args.opts or [])
    if args.root:
        args.opts += ["DATASET.ROOT", args.root]
    if args.checkpoint:
        args.opts += ["TEST.MODEL_FILE", args.checkpoint]
    cfg = to_port(load_config(args.cfg, opts=args.opts or []))
    logger, output_dir, _ = create_logger(cfg, args.cfg, "valid")
    model_file = cfg["TEST"]["MODEL_FILE"]
    if not model_file:
        print("ERROR: no checkpoint (pass --checkpoint or TEST.MODEL_FILE)")
        return 2
    model = get_model_builder(cfg["MODEL"]["NAME"])(cfg, device=args.device)
    load_model_file(model_file, model)
    logger.info("=> loaded %s", model_file)
    d = cfg["DATASET"]
    dataset = get_dataset_class(d["DATASET"])(cfg, d["ROOT"], d["TEST_SET"], is_train=False)
    name_value, _ = validate(cfg, dataset, model, output_dir, device=args.device,
                             max_batches=args.max_batches)
    got = dict(name_value)

    stem = Path(args.cfg).stem
    if args.expected:
        expected = {}
        for pair in args.expected.split(","):
            k, v = pair.split("=")
            expected[k.strip()] = float(v)
    else:
        expected = EXPECTED.get(stem)
    if expected is None:
        print(f"(no published expectation for {stem!r}; measured row only)")
        expected = {}

    # BASELINE.md row format
    cols = [k for k in expected if k in got] or [
        k for k in ("AP", "Ap .5", "AP .75", "AR") if k in got]
    print(f"\n{stem}\n{' | '.join(cols)}\n{' | '.join(f'{got[k]:.3f}' for k in cols)}\n")
    ok = True
    for k, want in expected.items():
        if k not in got:
            print(f"MISSING metric {k!r} (expected {want:.3f})")
            ok = False
            continue
        delta = got[k] - want
        status = "ok" if abs(delta) <= args.tol else "FAIL"
        ok &= status == "ok"
        print(f"{k:12s} got {got[k]:.4f}  expected {want:.3f}  delta {delta:+.4f}  [{status}]")
    print("\nRESULT:", "PASS" if ok else "FAIL",
          f"(tol ±{args.tol:g})" if expected else "(nothing to compare)")
    return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> int:
    return run(parse_args(argv))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
