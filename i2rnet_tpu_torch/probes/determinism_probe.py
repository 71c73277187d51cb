"""Which operation makes two float32 TPH training steps on one route differ.

    python3 -m i2rnet_tpu_torch.probes.determinism_probe    # repository root, on a card

``chip_smoke.py`` phase 28 runs one float32 training step of the seeded
TransPose-H I²R-Net (full width, dropout 0, the first 2 images of its
synthetic batch) on each route twice; two runs of one route differ. This
probe runs that step twice per route (kernels on, kernels off) and, for each
route:

1. the spread of the two runs (``chip_smoke.grad_diff``);
2. where it starts: each module's output and the gradient reaching that
   output (tensor hooks) in both runs, the first module in forward order
   whose output differs, the first in backward order whose output gradient
   differs, and the modules just before it in backward order (the consumers
   whose backward produced it); then the parameters whose gradients differ
   although the gradient of their module's output does not (a weight
   gradient that varies on its own);
3. in a child process with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` (cuDNN
   deterministic, benchmark off): the spread again, and every operation
   torch warns has no deterministic implementation.

It prints a verdict line per route; the exit code is 0 when every part ran.
"""

from __future__ import annotations

import os
import subprocess
import sys
import warnings

DETERMINISTIC = "--deterministic"


def step_records(model, cfg, raw, on):
    """One float32 step on the route ``on``: ({module: output}, [(module,
    output gradient)] in backward order, {parameter: gradient})."""
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch.core.train import compute_losses
    from i2rnet_tpu_torch.core.trainer import raw_to_device
    from i2rnet_tpu_torch.ops.preprocess import device_preprocess

    m = cfg["MODEL"]
    batch = device_preprocess(raw_to_device({k: v[:2] for k, v in raw.items()}, cs.DEV),
                              tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    outputs, grads, hooks, calls = {}, [], [], {}

    def record(name):
        def hook(module, args, out):
            if not isinstance(out, torch.Tensor):
                return
            calls[name] = calls.get(name, 0) + 1  # a module applied twice: name#1
            key = name if calls[name] == 1 else f"{name}#{calls[name] - 1}"
            outputs[key] = out.detach().clone()
            if out.requires_grad:
                out.register_hook(lambda g, k=key: grads.append((k, g.detach().clone())))
        return hook

    for name, module in model.named_modules():
        if name:
            hooks.append(module.register_forward_hook(record(name)))
    try:
        model.set_kernels(on)
        model.zero_grad(set_to_none=True)
        out = model(batch["images"], batch["pos_masks"], batch["person_valid"], train=True)
        loss, _ = compute_losses(out if isinstance(out, dict) else {"single": None, "multi": out},
                                 batch, m["LOSS_WEIGHTS"], True)
        loss.backward()
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    params = {n: p.grad.detach().clone() for n, p in model.named_parameters() if p.grad is not None}
    return outputs, grads, params


def first_differences(a, b):
    """The first module whose output differs in forward order, the first whose
    output gradient differs in backward order with the three before it, and
    the parameters whose gradient differs where their module's output
    gradient does not."""
    fwd = next((k for k in a[0] if not bool((a[0][k] == b[0][k]).all())), None)
    order = [k for k, _ in a[1]]
    gb = dict(b[1])
    bwd = next((i for i, (k, g) in enumerate(a[1]) if not bool((g == gb[k]).all())), None)
    same_grad = {k for k, g in a[1] if bool((g == gb[k]).all())}
    own = sorted((float((a[2][n] - b[2][n]).abs().max()), n) for n in a[2]
                 if not bool((a[2][n] == b[2][n]).all()) and n.rsplit(".", 1)[0] in same_grad)
    return fwd, (None if bwd is None else (order[bwd], order[max(0, bwd - 3):bwd])), own[::-1]


def describe(model, name):
    import torch

    if name is None:
        return "none"
    base = name.split("#")[0]
    module = dict(model.named_modules()).get(base)
    return f"{name} ({type(module).__name__ if isinstance(module, torch.nn.Module) else '?'})"


def run(deterministic: bool) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from i2rnet_tpu_torch import presets
    from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
    from i2rnet_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    caught = []
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.benchmark = False
        warnings.simplefilter("always")
        warnings.showwarning = lambda msg, *a, **k: caught.append(str(msg))
    build.build()
    build.library()
    cfg = cs.train_cfg("float32", True, presets.tph_interformer)
    raw = synthetic_raw_batch(cfg, cs.TPH_TRAIN_PERSONS, np.random.RandomState(cs.SEED))
    model = cs.seeded_model(cfg)
    for encoder in model.encoders():
        encoder.dropout_rate = 0.0
    label = "deterministic algorithms" if deterministic else "default algorithms"
    for on in (True, False):
        route = "kernels on" if on else "kernels off"
        a, b = step_records(model, cfg, raw, on), step_records(model, cfg, raw, on)
        diff = cs.grad_diff(b[2], a[2])
        same = all(torch.equal(a[2][n], b[2][n]) for n in a[2])
        print(f"{label}, {route}: two runs {'bit-equal' if same else 'differ'}; "
              + cs.describe_diff(diff), flush=True)
        if not same and not deterministic:
            fwd, bwd, own = first_differences(a, b)
            print(f"  first module output that differs (forward order): {describe(model, fwd)}",
                  flush=True)
            if bwd is not None:
                print(f"  first output gradient that differs (backward order): "
                      f"{describe(model, bwd[0])}; the backward just before it ran for: "
                      + ", ".join(describe(model, k) for k in bwd[1]), flush=True)
            print(f"  {len(own)} parameter gradients differ where their module's output "
                  "gradient is equal; largest: "
                  + ", ".join(f"{n} {d:.3g}" for d, n in own[:8]), flush=True)
        del a, b
        torch.cuda.empty_cache()
    if deterministic:
        ops = sorted({m.split(" does not have")[0].strip() for m in caught
                      if "deterministic" in m})
        print(f"  operations torch reports without a deterministic implementation: "
              f"{ops or 'none'}", flush=True)
    return 0


def main() -> int:
    if DETERMINISTIC in sys.argv:
        return run(True)
    code = run(False)
    env = {**os.environ, "CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    child = subprocess.run([sys.executable, "-m", "i2rnet_tpu_torch.probes.determinism_probe",
                            DETERMINISTIC], env=env, timeout=900)
    return code or child.returncode


if __name__ == "__main__":
    sys.exit(main())
