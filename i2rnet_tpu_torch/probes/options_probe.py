"""Card check of the options slice alone: ``chip_smoke.py`` phases 53-56,
without the earlier phases, and the main path's Kernel A and B times.

    python3 -m i2rnet_tpu_torch.probes.options_probe [--w48-only]   # repository root, on a card

Builds the kernels and prints the compiler's registers and spills of every
kernel of Kernels A-D's sources (the wide instances among them); then Kernel
A and B at the W48 eval shape (B=16, S=1344, C=96) as device time per call
(``chip_smoke.py`` phase 7's timing); then, unless ``--w48-only``, phases
53-56 and the ``CUDNN.BENCHMARK`` measurement (:func:`cudnn_benchmark`).
With ``--w48-only`` it runs from another checkout's root too
(``PYTHONPATH=. python3 <this tree>/i2rnet_tpu_torch/probes/options_probe.py
--w48-only``), timing that checkout's kernels with the same calls. A phase
that fails is reported and the next one still runs; the probe then exits 1.
"""

from __future__ import annotations

import sys
import time
import traceback


def cudnn_benchmark(cs, g, card):
    """The recipes' ``CUDNN.BENCHMARK`` (``config.apply_cudnn``) on the W48
    eval step of ``chip_smoke.py`` phase 7 (B=16 x N=7, bf16, kernels on,
    seeded and calibrated weights): the step's ms by CUDA events and, from
    a profile of two steps, wall and device-busy ms a step, with
    ``torch.backends.cudnn.benchmark`` off and on in turns (off, on, on,
    off; each setting's first steps outside the timing, where cuDNN picks
    its algorithms); then phase 51's reading under each setting: the bf16
    forward of a batch of 8 images against its two halves of 4, as the
    largest difference over the largest heat."""
    import torch

    from i2rnet_tpu_torch import presets

    cfg = presets.w48_pure_en6()
    model = cs.random_model(cfg, g)
    step = cs.eval_steps(model, cfg, model.set_kernels, 16, 7, g)(True)
    cudnn = torch.backends.cudnn
    was = cudnn.benchmark
    rows = {False: [], True: []}
    try:
        for bench in (False, True, True, False):
            cudnn.benchmark = bench
            step()
            step()
            ms = cs.time_cuda(step, 5)
            wall, busy, launches, _ = cs.profile_steps(step, 2)
            rows[bench].append((ms, wall, busy, launches))
        for bench, runs in rows.items():
            print(f"  W48 eval step B=16 N=7 bf16, cudnn.benchmark {bench}: "
                  + "; ".join(f"{ms:.2f} ms by events, profile wall {wall:.2f} ms, device busy "
                              f"{busy:.2f} ms, {launches:.0f} launches"
                              for ms, wall, busy, launches in runs) + f" [{card}]", flush=True)
        images, pos, valid = cs.person_inputs(cfg, 8, 7, cs.TRAIN_COUNTS, g)
        model.compute_dtype = torch.bfloat16
        for bench in (False, True):
            cudnn.benchmark = bench
            for on in (True, False):
                model.set_kernels(on)
                with torch.no_grad():
                    whole = model(images, pos, valid)
                    halves = torch.cat([model(images[:4], pos[:4], valid[:4]),
                                        model(images[4:], pos[4:], valid[4:])])
                rel = (whole - halves).abs().max().item() / whole.abs().max().item()
                print(f"  W48 forward bf16, cudnn.benchmark {bench}, kernels "
                      f"{'on' if on else 'off'}: max|whole batch - its halves|/max|heat| "
                      f"{rel:.3g}", flush=True)
    finally:
        cudnn.benchmark = was


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
    sources = ("mhsa.cu", "mhsa_train.cu", "encoder_ffn.cu", "encoder_ffn_train.cu",
               "encoder_ffn_train_wide.cu")
    for src, name, regs, st, ld in kernel_resources(so.with_suffix(".log").read_text(), sources):
        print(f"  {src:20s} {name:70s} {regs:4d} registers, spills {st}/{ld} B", flush=True)
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

    def w48():
        b, s = 16, 1344
        times = {**cs.phase_timing_mhsa(g, card, b, s), **cs.ffn_timing(g, card, b * s)}
        cs.log_eval_times(times, b, s, card)

    phase(f"Kernels A and B at the W48 eval shape [{card}]:", w48)
    if "--w48-only" not in sys.argv:
        phase("phase 53 the last model options:", lambda: cs.phase_options(g, card))
        phase("phase 54 Kernels A-D at the cat_vec widths:",
              lambda: cs.phase_wide_kernels(g, card))
        phase("phase 55 the cat_vec and window training steps:",
              lambda: cs.phase_option_training(card))
        phase("phase 56 the device NMS:", lambda: cs.phase_nms(card))
        phase(f"CUDNN.BENCHMARK on the W48 eval step [{card}]:",
              lambda: cudnn_benchmark(cs, g, card))
    print("PROBE FAILED: " + "; ".join(failed) if failed else "PROBE OK", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
