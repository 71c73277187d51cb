"""One rank of a data-parallel run, and the launcher that starts the ranks.

    python3 -m i2rnet_tpu_torch.probes.ddp_rank CASE RANK WORLD INIT FOLDER [DEVICE [BACKEND]]

joins the process group at ``INIT`` (a ``file://`` or ``tcp://`` address) as
rank ``RANK`` of ``WORLD`` on ``DEVICE`` (``cuda`` unless given; ``BACKEND``
``gloo`` or ``nccl``, else the device's default), reads the job that
:func:`run_ranks` wrote to ``FOLDER/job.pt``, runs ``CASE`` on its rows of
it and writes what it saw to ``FOLDER/rank{RANK}.pt``. The cases:

* ``bn``: a :class:`~..models.layers.MaskedBatchNorm` training forward and
  backward over the rank's contiguous block of a global ``[B, C, H, W]``
  input (with ``remat``, recomputed in the backward); the output, the input
  gradient, the summed weight and bias gradients, the running statistics;
* ``step``: one ``make_train_step`` step of the job's model (the parameters
  that ``MODEL.SINGLEFORMER_FIX`` and ``BACKBONE_FIX`` name frozen, as
  ``train_loop`` freezes them) and global device batch (``rows`` ``split``: the rank's block of images; ``all``:
  every rank the whole batch, so that only the per-rank dropout seed makes
  the ranks differ): the global metrics, the state dict and the summed gradients after the
  step, the training forward's ``multi`` heatmaps, the kernels' launches,
  and whether every rank holds the same parameters;
* ``validate``: ``core.validate.validate`` on the job's dataset, once for
  each of its ``runs``, with the GT-heatmap oracle (no ``state_dict``) or the
  run's weights: ``name_value``, ``perf``, the launches and the results file
  of the rank's ``proc<rank>``;
* ``train``: ``core.trainer.train_loop`` from the job's dataset, recording
  which ranks write checkpoints: the epochs each rank saved, the final state
  dict and the step losses.

The CPU tests (``tests/test_torch_ddp.py``) and ``chip_smoke.py`` start the
ranks through :func:`run_ranks`, each with a time limit; a rank that fails
or runs out of time fails the run, and the other ranks are stopped.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from i2rnet_tpu_torch.parallel import dist

ROOT = Path(__file__).resolve().parents[2]


def _rows(n: int) -> slice:
    """This rank's contiguous block of ``n`` rows (``n`` divisible by the world)."""
    world = dist.world_size()
    if n % world:
        raise ValueError(f"{n} rows do not split over {world} ranks")
    per = n // world
    return slice(dist.rank() * per, (dist.rank() + 1) * per)


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if torch.is_tensor(tree) else tree


def case_bn(job: Dict, device) -> Dict:
    from i2rnet_tpu_torch.models.layers import MaskedBatchNorm, remat

    x, cot, mask = job["x"], job["cot"], job.get("mask")
    rows = _rows(x.shape[0])
    bn = MaskedBatchNorm(x.shape[1]).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(job["weight"])
        bn.bias.copy_(job["bias"])
    bn.person_mask = None if mask is None else mask[rows].to(device)
    xr = x[rows].to(device).requires_grad_()
    y = remat(bn, bn, xr) if job.get("remat") else bn(xr)
    (y * cot[rows].to(device)).sum().backward()
    dist.all_reduce_grads([bn.weight, bn.bias])
    return _cpu({"y": y, "dx": xr.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
                 "running_mean": bn.running_mean, "running_var": bn.running_var,
                 "num_batches_tracked": bn.num_batches_tracked})


def _model(job: Dict, device):
    from i2rnet_tpu_torch.models.interformer import build_model

    model = build_model(job["cfg"], device="cpu")
    model.load_state_dict(job["state_dict"])
    return model.to(device)


def case_step(job: Dict, device) -> Dict:
    from i2rnet_tpu_torch.core.pretrained import freeze
    from i2rnet_tpu_torch.core.train import make_train_step
    from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
    from i2rnet_tpu_torch.ops.cuda import launch_counts, reset_launches

    cfg = job["cfg"]
    model = _model(job, device)
    freeze(cfg, model)
    for encoder in model.encoders():
        encoder.dropout_rate = job["dropout"]
    state = TrainState(model, *make_optimizer(cfg, [p for p in model.parameters()
                                                    if p.requires_grad], steps_per_epoch=1))
    step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"],
                           cfg["LOSS"]["USE_TARGET_WEIGHT"],
                           remat=cfg["DEVICE"].get("REMAT", False))
    batch = job["batch"]
    rows = _rows(batch["images"].shape[0]) if job.get("rows", "split") == "split" else slice(None)
    local = {k: v[rows].to(device) for k, v in batch.items()}
    seen = []
    hook = model.register_forward_hook(
        lambda _m, _a, out: seen.append((out["multi"] if isinstance(out, dict) else out)
                                        .detach().cpu().clone()))
    reset_launches()
    metrics = step(local, torch.Generator().manual_seed(0))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    hook.remove()
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state_dict": _cpu(model.state_dict()), "multi": seen[0],
            "grads": {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                      if p.grad is not None},
            "launches": launch_counts(),
            "same": dist.same_on_every_rank(list(model.state_dict().values()))}


def case_validate(job: Dict, device) -> Dict:
    from i2rnet_tpu_torch.core.validate import validate
    from i2rnet_tpu_torch.ops.cuda import launch_counts, reset_launches
    from i2rnet_tpu_torch.registry import get_dataset_class

    cfg = job["cfg"]
    d = cfg["DATASET"]
    ds = get_dataset_class(d["DATASET"])(cfg, job["root"], d["TEST_SET"], is_train=False)
    out = []
    for run in job["runs"]:
        model, oracle = None, None
        if run.get("state_dict") is None:
            oracle = lambda _m, batch: batch["target"]  # noqa: E731  (the GT-heatmap oracle)
        else:
            model = _model({**job, **run}, device).eval()
        reset_launches()
        name_value, perf = validate(cfg, ds, model, run["out"], eval_step_fn=oracle,
                                    device=device)
        results = sorted(Path(dist.proc_dir(run["out"])).glob("results/*.json"))
        out.append({"name_value": dict(name_value), "perf": float(perf),
                    "launches": launch_counts(),
                    "results": results[0].read_bytes() if results else b""})
    return {"runs": out}


def case_train(job: Dict, device) -> Dict:
    from i2rnet_tpu_torch.core import trainer

    saved = []
    save = trainer.save_checkpoint

    def recording(output_dir, epoch, *args, **kw):
        saved.append(epoch)
        return save(output_dir, epoch, *args, **kw)

    trainer.save_checkpoint = recording
    losses = []
    state = trainer.train_loop(job["cfg"], job["out"], max_epochs=job["max_epochs"],
                               max_steps_per_epoch=job["max_steps"], device=device,
                               on_step=lambda e, i, m: losses.append(float(m["loss"])))
    return {"saved": saved, "losses": losses, "state_dict": _cpu(state.model.state_dict())}


CASES = {"bn": case_bn, "step": case_step, "validate": case_validate, "train": case_train}


def main(argv: List[str]) -> int:
    case, rank, world, init, folder = argv[0], int(argv[1]), int(argv[2]), argv[3], argv[4]
    device = argv[5] if len(argv) > 5 else "cuda"
    backend = argv[6] if len(argv) > 6 else None
    if torch.device(device).type == "cpu":
        torch.set_num_threads(2)  # the ranks share the host's cores
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init(num_processes=world, process_id=rank, backend=backend, device=device,
              init_method=init)
    job = torch.load(Path(folder) / "job.pt", weights_only=False)
    result = CASES[case](job, device)
    torch.save(result, Path(folder) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy()
    return 0


def run_ranks(case: str, job: Dict, world: int, folder, device: str = "cuda",
              backend: Optional[str] = None, timeout: float = 300.0) -> List[Dict]:
    """Run ``case`` on ``job`` in ``world`` rank processes (this package's
    Python, a ``file://`` rendezvous in ``folder``), each stopped after
    ``timeout`` seconds; returns each rank's result in rank order. A rank
    that fails or runs out of time raises, after the others are stopped."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    for old in [folder / "rendezvous", *folder.glob("rank*.pt")]:
        old.unlink(missing_ok=True)
    torch.save(job, folder / "job.pt")
    init = dist.file_init_method(folder / "rendezvous")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    args = [case, None, str(world), init, str(folder), device] + ([backend] if backend else [])
    procs, logs = [], []
    for r in range(world):
        log = open(folder / f"rank{r}.log", "w")
        logs.append(log)
        argv = [sys.executable, "-m", "i2rnet_tpu_torch.probes.ddp_rank"] + [
            str(r) if a is None else a for a in args]
        procs.append(subprocess.Popen(argv, cwd=ROOT, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    fault = "ran out of time"
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                fault = f"rank {bad[0]} failed"
                break
            if all(c == 0 for c in codes):
                fault = None
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if fault:
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                          + (folder / f"rank{r}.log").read_text()[-3000:]
                          for r, p in enumerate(procs))
        raise RuntimeError(f"data-parallel case {case!r} over {world} ranks: {fault} "
                           f"(limit {timeout:.0f} s)\n{tails}")
    return [torch.load(folder / f"rank{r}.pt", weights_only=False) for r in range(world)]


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
