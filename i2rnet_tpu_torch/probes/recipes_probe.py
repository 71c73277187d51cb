"""Card check of the recipes slice alone: ``chip_smoke.py`` phases 34-40,
without the earlier phases.

    python3 -m i2rnet_tpu_torch.probes.recipes_probe   # repository root, on a card

Builds the kernels; reads the ten recipes with the port's YAML reader
against ``expected_recipes.json`` (phase 34); holds the new kernel shapes
and runs the five recipes not run before from their YAML through
``tools.train`` and ``tools.test`` (phases 35-39); MPII's PCKh with the
oracle and a seeded 16-joint W48 kernels on vs off (phase 40). A phase that
fails is reported and the next one still runs; the probe then exits 1.
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

    phase("phase 34 the ten recipes read from their YAML:", cs.phase_read_recipes)
    for run in cs.RECIPE_RUNS:
        phase(f"phase {run[0]} {run[1]}:", lambda run=run: cs.phase_recipes(g, card, (run,)))
    phase("phase 40 MPII:", lambda: cs.phase_mpii(g, card))
    print("PROBE FAILED: " + "; ".join(failed) if failed else "PROBE OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
