"""Card check of the TransPose-H training slice alone: ``chip_smoke.py``
phases 27-29, without the earlier phases.

    python3 -m i2rnet_tpu_torch.probes.tph_train_probe [--kernels]   # repository root, on a card

Builds the kernels; Kernels C and D at the TPH training shapes against their
plain versions, with their device times beside SDPA (phase 27); the TPH
I²R-Net trained through ``train_loop`` at full width, C and D launched by
each encoder, and one f32 step kernels on vs off (phase 28); the TPH train
step's timing and profile with C's and D's intra/inter split (phase 29).
``--kernels`` stops after phase 27. A phase that fails is reported and the
next one still runs; the probe then exits 1.
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
    failed, state = [], {}

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

    phase("phase 27 Kernels C and D at the TPH training shapes vs plain:",
          lambda: cs.phase_tph_train_kernels(card))
    if "--kernels" not in sys.argv:
        def train():
            state["raw"] = cs.phase_tph_train(cs.TPH_TRAIN_PERSONS)[2]

        phase("phase 28 training the TPH I²R-Net through train_loop (bf16, B=4 N=4):", train)
        if "raw" in state:
            phase("  one f32 step at dropout 0, kernels on vs off:",
                  lambda: cs.phase_tph_train_on_off(state["raw"]))
            phase(f"phase 29 TPH training timing [{card}]:",
                  lambda: cs.phase_tph_train_timing(state["raw"], cs.TPH_TRAIN_PERSONS, card))
    print(f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB", flush=True)
    print("PROBE FAILED: " + "; ".join(failed) if failed else "PROBE OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
