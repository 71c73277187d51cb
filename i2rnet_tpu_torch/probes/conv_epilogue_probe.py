"""Card check of the folded conv units and their epilogue (``csrc/conv_epilogue.cu``).

    python3 -m i2rnet_tpu_torch.probes.conv_epilogue_probe     # repository root, on a card

Builds the kernels, prints the compiler's registers and spills of the
epilogue's instances, and runs ``chip_smoke.py`` phase 58 alone (the kernel
against its plain version, its times, and a profiled W48 eval forward of the
served bucket).
"""

from __future__ import annotations

import sys
import time


def main() -> int:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.probes.mhsa_probe import kernel_resources

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.time()
    so = build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s", flush=True)
    for src, name, regs, st, ld in kernel_resources(so.with_suffix(".log").read_text(),
                                                    ("conv_epilogue.cu",)):
        print(f"  {src:20s} {name:60s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
    cs.log(f"phase 58 the folded conv units' epilogue [{card}]:")
    cs.phase_conv_epilogue(cs.gen(cs.SEED), card)
    print("PROBE OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
