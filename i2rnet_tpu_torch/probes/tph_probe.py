"""Card check of the TransPose-H slice alone: ``chip_smoke.py`` phases 24-26
and phase 23's TPH run, without the earlier phases.

    python3 -m i2rnet_tpu_torch.probes.tph_probe [--kernels]   # repository root, on a card

Builds the kernels; Kernels A and B at the TPH intra encoder's shapes against
their plain versions with their device times beside SDPA (phase 24); the
full-width TPH I²R-Net kernels on vs off and served through ``Predictor``
(phase 25); its eval protocol with the intra/inter split of A and B (phase
26); ``validate`` on the fixture with the seeded TPH model (phase 23's TPH
run). ``--kernels`` stops after phase 24.
"""

from __future__ import annotations

import sys
import time


def main() -> None:
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch import presets
    from i2rnet_tpu_torch.data.coco import COCODataset
    from i2rnet_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    t0 = time.time()
    build.build()
    build.library()
    print(f"build {time.time() - t0:.1f}s", flush=True)
    print("phase 24 Kernels A and B at the TPH intra encoder's shapes vs plain:", flush=True)
    cs.phase_tph_kernels(card)
    if "--kernels" in sys.argv:
        print("PROBE OK")
        return
    torch.cuda.empty_cache()
    g = cs.gen(cs.SEED)
    cfg = presets.tph_interformer()
    print("phase 25 TPH I²R-Net full width, f32, B=2 N=4, kernels on vs off:", flush=True)
    model = cs.phase_tph_model(cfg, g)
    cs.phase_serve(model, cfg, model.set_kernels, batch_images=8, n_buckets=(2, 4),
                   per_call=2 * cs.TPH_LAUNCHES)
    print(f"phase 26 TPH timing [{card}]:", flush=True)
    cs.phase_tph_timing(model, cfg, g, card)
    del model
    torch.cuda.empty_cache()
    print("phase 23 (TPH) validate on the fixture:", flush=True)
    cfg = cs.tph_fixture_cfg()
    ds = COCODataset(cfg, str(cs.FIXTURE), "val2017", is_train=False)
    cs.phase_validate_model(cfg, ds, g, card, "validate_tph")
    print("PROBE OK")


if __name__ == "__main__":
    main()
