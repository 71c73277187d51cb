"""What bounds Kernel F's bf16 body: the same kernel with a part of its work
swapped out, timed per branch in one call.

Builds variants of the package in copies under ``.local/mlp_sweep/``
(gitignored), each with ``csrc/mlp_dwbn.cuh`` edited, and prints for each F's
device time per call at 256x192's four branch maps (bf16, P=32), summed over
one HRT eval step's 88 calls, and F's max |error| / max |ref| against the
plain version (``chip_smoke.HRT_TOL`` bf16 is 1e-2). The variants:

- ``shipped``: the source as it is;
- ``tanh.approx``: the GELU's ``tanhf`` as ``tanh.approx.f32`` (one MUFU
  instruction, max relative error about 2^-11);
- ``no tanh``: tanh(p) = 0 (wrong values: the time without the tanh);
- ``no expand products``, ``no expand GELU``, ``no depthwise``, ``no
  contract``: that part of each chunk left out (wrong values: what it costs).

    python3 -m i2rnet_tpu_torch.probes.mlp_sweep [variant ...]   # repository root, on a card
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
OUT = REPO / ".local" / "mlp_sweep"
TANH = "return 0.5f * x * (1.f + tanhf(p));"
EXPAND_MMA = """                amma::ldsm_x4(a, ys + amma::a_off(lane, mt * 16, kk * 16, ldy));
                amma::mma(e[mt], a, b.x, b.y);"""
EXPAND_GELU = """                amma::pack(gelu_tanh_erf(e[mt][2 * half] + eb0),
                           gelu_tanh_erf(e[mt][2 * half + 1] + eb1));"""
DEPTHWISE = "for (int item = tid; item < th * (kHC / 2); item += kThreads) {"
CONTRACT = "for (int t0 = warp; t0 < ntiles; t0 += kWarps * kGroup) {"
#: name: [(text of mlp_dwbn.cuh, its replacement)]
VARIANTS = {
    "shipped": [],
    "tanh.approx": [(TANH, "float t;\n  asm(\"tanh.approx.f32 %0, %1;\" : \"=f\"(t) : \"f\"(p));\n"
                           "  return 0.5f * x * (1.f + t);")],
    "no tanh": [(TANH, "return 0.5f * x;")],
    "no expand products": [(EXPAND_MMA, "                e[mt][0] += __uint_as_float(b.x);")],
    "no expand GELU": [(EXPAND_GELU, "amma::pack(e[mt][2 * half] + eb0, e[mt][2 * half + 1] + eb1);")],
    "no depthwise": [(DEPTHWISE, DEPTHWISE.replace("item < th * (kHC / 2)", "item < 0"))],
    "no contract": [(CONTRACT, CONTRACT.replace("t0 < ntiles", "t0 < 0"))],
}


def time_variant(name: str) -> None:
    """Run inside a variant's directory: F's error and device time per branch."""
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.ops.cuda import build
    from i2rnet_tpu_torch.ops.cuda.hrformer_block import mlp_block_fused, mlp_block_torch
    from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import pack_mlp

    # only F's source: the variants differ there, and the other kernels' build takes a minute
    build.sources = lambda: [build.CSRC / "mlp_dwbn.cu"]
    build.SIGNATURES = {k: build.SIGNATURES[k] for k in ("i2r_mlp_block_fwd", "i2r_mlp_dwbn_fwd")}
    build.library()
    g = cs.gen(0)
    total = 0.0
    for shape, n in zip(cs.HRT_SHAPES[:4], (28, 28, 24, 8)):  # F's calls per HRT eval step
        p, h, w, c, heads = shape
        _, _, mlp = cs.hrt_kernel_args(c, heads, g)
        ln = (1 + 0.2 * cs.randn(c, g=g), 0.1 * cs.randn(c, g=g))
        x = cs.randn(p, h, w, c, g=g, dtype=torch.bfloat16)
        packed = pack_mlp(*mlp, torch.bfloat16, x.device)
        with torch.no_grad():
            got = mlp_block_fused(x, *ln, *mlp, packed=packed).float()
            ref = mlp_block_torch(x, *ln, *mlp).float()
            rel = ((got - ref).abs().max() / ref.abs().max()).item()
            ms = cs.device_ms(lambda: mlp_block_fused(x, *ln, *mlp, packed=packed), 10)
        total += n * ms
        print(f"  {name} {shape}: F {ms * 1e3:.1f} us device per call, max|err|/max|ref| "
              f"{rel:.3g}", flush=True)
    print(f"  {name}: summed over one HRT eval step's 88 calls {total:.2f} ms [{cs.card_line()}]",
          flush=True)


def run_variants(names, variants, files, module, out) -> None:
    """Copy the package to ``out``/<variant> for each variant of ``names``
    (all of ``variants`` when empty), apply its (old, new) edits to the
    package's files ``files`` (paths inside ``i2rnet_tpu_torch/``; each edit
    to the first file that holds its text, which must hold it), and run
    ``python -m module --time <variant>`` there."""
    pkg = REPO / "i2rnet_tpu_torch"
    failed = []
    for name in names or variants:
        texts = {f: (pkg / f).read_text() for f in files}
        for old, new in variants[name]:
            where = [f for f in files if old in texts[f]]
            if not where:
                raise RuntimeError(f"{files} no longer have {old!r}")
            texts[where[0]] = texts[where[0]].replace(old, new)
        d = out / name.replace(" ", "_").replace(".", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(REPO / "i2rnet_tpu_torch", d / "i2rnet_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(REPO / "chip_smoke.py", d / "chip_smoke.py")
        for f, text in texts.items():
            (d / "i2rnet_tpu_torch" / f).write_text(text)
        env = {**os.environ, "PYTHONPATH": str(d)}
        proc = subprocess.run([sys.executable, "-m", module, "--time", name], cwd=d, env=env,
                              timeout=600)
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise SystemExit(f"variants failed: {failed}")
    print("SWEEP OK")


def main(names) -> None:
    run_variants(names, VARIANTS, ("csrc/mlp_dwbn.cuh",), "i2rnet_tpu_torch.probes.mlp_sweep", OUT)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--time"]:
        time_variant(sys.argv[2])
    else:
        main(sys.argv[1:])
