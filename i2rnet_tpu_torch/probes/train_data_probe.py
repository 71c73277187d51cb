"""Card check of the training data slice alone: ``chip_smoke.py`` phases
30-33, without the earlier phases.

    python3 -m i2rnet_tpu_torch.probes.train_data_probe   # repository root, on a card

Builds the kernels; the training data path on the three fixtures (phase 30);
W48 COCO trained from JPEGs through ``train_loop`` and validated (phase 31);
the CrowdPose and OCHuman W48 recipes at their shapes: Kernels A-D against
their plain versions and timed, ``train_loop`` from the fixture, ``validate``
with the oracle and the seeded model (phases 32-33). A phase that fails is
reported and the next one still runs; the probe then exits 1.
"""

from __future__ import annotations

import sys
import time
import traceback


def main() -> int:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.time()
    build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s", flush=True)
    failed = []
    g = cs.gen(cs.SEED)

    def phase(label, fn):
        print(label, flush=True)
        t = time.time()
        try:
            fn()
        except Exception:  # report, and go on to the next phase
            traceback.print_exc()
            failed.append(label)
        torch.cuda.empty_cache()
        print(f"  ({time.time() - t:.1f} s)", flush=True)

    phase("phase 30 the training data path:", lambda: cs.phase_train_data(card))
    phase("phase 31 W48 COCO from JPEGs:", lambda: cs.phase_train_jpegs(card))
    phase("phase 32 CrowdPose W48:", lambda: cs.phase_dataset_recipe("crowdpose", g, card))
    phase("phase 33 OCHuman W48:", lambda: cs.phase_dataset_recipe("OCHuman", g, card))
    print("PROBE FAILED: " + "; ".join(failed) if failed else "PROBE OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
