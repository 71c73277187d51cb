"""Card check of the serving slice alone: ``chip_smoke.py`` phases 41-44,
without the earlier phases.

    python3 -m i2rnet_tpu_torch.probes.serving_probe   # repository root, on a card

Builds the kernels; exports the W48, TPH and HRT artifacts through
``tools.export``, serves the W48 one in a fresh process and the
``--no-kernels`` one here (phase 41); times artifact against in-process
serving and the op's host cost (phase 42); the fresh process's
``MicroBatcher`` under a Poisson stream (phase 43); the hub's W48 and the
TPH and HRT artifacts (phase 44). Exits 1 on the first failure.
"""

from __future__ import annotations

import sys
import time


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
    t0 = time.time()
    launches = cs.phase_serving(cs.gen(cs.SEED), card)
    print(f"phases 41-44: {time.time() - t0:.1f} s; launches {launches}", flush=True)
    print("PROBE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
