"""Card check of the evaluation slice: which image libraries the machine has,
then ``chip_smoke.py``'s phase 23 (the fixture's JPEGs decoded to
``cv2.imread``'s bytes, ``validate`` with the GT-heatmap oracle against the
JAX stats, the seeded W48-pure-en6 in bf16 with Kernels A and B on and off,
the time split per batch) and one profile of the W48 eval step
(``profile_steps``, with the count of ``#``-named kernels).

    python3 -m i2rnet_tpu_torch.probes.validate_probe [--libraries]   # repository root, on a card

``--libraries`` only reports the image libraries (Pillow, torchvision,
imageio, OpenCV), their versions, and stops: it needs no card.
"""

from __future__ import annotations

import importlib
import sys
import time

LIBRARIES = ("PIL", "torchvision", "imageio", "cv2")


def report_libraries() -> None:
    for name in LIBRARIES:
        try:
            mod = importlib.import_module(name)
        except ImportError as e:
            print(f"{name}: not importable ({e})", flush=True)
        else:
            print(f"{name}: {getattr(mod, '__version__', '?')}", flush=True)


def main() -> None:
    report_libraries()
    if "--libraries" in sys.argv[1:]:
        return
    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build

    t0 = time.perf_counter()
    card = cs.card_line()
    cs.log(card)
    cs.torch.backends.cuda.matmul.allow_tf32 = False
    cs.torch.backends.cudnn.allow_tf32 = False
    build.build()
    build.library()
    cs.log(f"build {time.perf_counter() - t0:.1f} s")
    g = cs.gen(cs.SEED)
    decode_ms = cs.phase_decode(card)
    cfg = cs.fixture_cfg()
    ds = cs.COCODataset(cfg, str(cs.FIXTURE), "val2017", is_train=False)
    cs.phase_validate_oracle(cfg, ds)
    model = cs.phase_validate_model(cfg, ds, g, card)
    cs.phase_validate_split(model, cfg, ds, decode_ms, card)
    step = cs.eval_steps(model, cfg, model.set_kernels, 16, 7, g)
    wall, busy, launches, top = cs.profile_steps(step(True), 2)
    cs.log(f"W48 eval step B=16 N=7 bf16: wall {wall:.2f} ms under the profiler, busy "
           f"{busy:.2f} ms, {launches:.0f} launches a step [{card}]")
    for name, t, c in top[:15]:
        cs.log(f"  {t:8.3f} {c:6.0f}  {name[:120]}")
    cs.log(f"total {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
