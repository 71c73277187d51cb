"""Data parallelism across processes: the process group and its collectives.

Port of ``i2rnet_tpu/parallel/mesh.py`` and of the multi-host flags of the
JAX ``tools/train.py:31-47`` (``jax.distributed.initialize``). The JAX
package shards one global batch over a device mesh and lets XLA insert the
collectives; here each process holds one rank's rows, as the reference's
``torchrun`` + ``DistributedDataParallel`` did (``tools/ddp_train.py:87-98``),
and the port calls the collectives itself:

* :func:`init` starts the process group from explicit arguments
  (``--coordinator host:port``, ``--num-processes``, ``--process-id``, or an
  ``init_method`` such as :func:`file_init_method`'s, which tests use so that
  concurrent runs never race for a port) or from torchrun's environment
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``).
  The backend is ``nccl`` on CUDA and ``gloo`` on the CPU, or ``gloo`` on
  CUDA when asked; ``nccl`` where CUDA or NCCL is missing raises.
* :func:`all_reduce_sum` carries autograd: its backward all-reduces the
  gradient, as torch's ``SyncBatchNorm`` does, so a loss that is the sum of
  every rank's part gets the global gradient on every rank.
* :func:`all_reduce_grads` sums the gradients of a list of parameters in one
  flattened all-reduce; :func:`broadcast_module` copies rank 0's parameters
  and buffers to every rank; :func:`gather_host` gathers host objects (numpy
  arrays) in rank order.

Every helper is a no-op in a world of one, so an undistributed run is the
run it was. Data parallelism only: the JAX package's tensor-parallel
sharding and hybrid DCN mesh were TPU-slice tooling and are not ported.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence

import torch
import torch.distributed as tdist

BACKENDS = ("nccl", "gloo")
#: how long a collective waits for the other ranks before it raises
TIMEOUT_S = 600.0


def file_init_method(path) -> str:
    """A ``file://`` rendezvous at ``path`` (a file that does not exist yet)."""
    return "file://" + os.path.abspath(os.fspath(path))


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_device(device="cuda", process_id: Optional[int] = None) -> torch.device:
    """The device this rank runs on: ``device`` as given when it names an
    index or the CPU, else the card of ``LOCAL_RANK`` (torchrun), or of
    ``process_id`` modulo the cards present."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = _env_int("LOCAL_RANK")
    if local is None:
        local = (process_id or 0) % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", local)


def check_backend(backend: str, device) -> None:
    """Raise unless ``backend`` can serve ``device``: ``nccl`` needs CUDA and
    NCCL, and CUDA tensors; ``gloo`` serves both."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: expected one of {BACKENDS}")
    if backend == "nccl":
        if not (torch.cuda.is_available() and tdist.is_nccl_available()):
            raise RuntimeError("the nccl backend needs CUDA and NCCL, which this torch lacks")
        if torch.device(device).type != "cuda":
            raise ValueError(f"the nccl backend serves CUDA tensors, not {device}")


def init(coordinator: str = "", num_processes: Optional[int] = None,
         process_id: Optional[int] = None, backend: Optional[str] = None, device="cuda",
         init_method: Optional[str] = None) -> bool:
    """Start the process group; returns whether one was started.

    Explicit arguments win: ``init_method`` (or ``tcp://{coordinator}``) with
    ``num_processes`` ranks, this one ``process_id``. Without them torchrun's
    environment is read (``WORLD_SIZE`` and ``RANK``, ``env://``); without
    that either no group is started (one process, nothing to do). The
    backend defaults to ``nccl`` for a CUDA ``device`` and ``gloo`` for the
    CPU. On CUDA the rank's card (:func:`local_device`) becomes the current
    device. A collective that waits longer than ``TIMEOUT_S`` raises."""
    if tdist.is_initialized():
        return False
    if coordinator and not init_method:
        init_method = f"tcp://{coordinator}"
    if init_method:
        world = 1 if num_processes is None else int(num_processes)
        rank_ = 0 if process_id is None else int(process_id)
    elif (num_processes or 1) != 1 or (process_id or 0) != 0:
        raise ValueError("--num-processes and --process-id need a --coordinator (or an "
                         "init_method)")
    elif _env_int("WORLD_SIZE") is not None:
        init_method, world, rank_ = "env://", _env_int("WORLD_SIZE"), _env_int("RANK") or 0
    else:
        return False
    dev = local_device(device, rank_)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    check_backend(backend, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    from datetime import timedelta
    tdist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_,
                             timeout=timedelta(seconds=TIMEOUT_S))
    return True


def destroy() -> None:
    """End the process group (where one is running)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def world_size() -> int:
    return tdist.get_world_size() if initialized() else 1


def rank() -> int:
    return tdist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Whether this process writes checkpoints and logs (rank 0)."""
    return rank() == 0


def active() -> bool:
    """Whether a process group of more than one rank is running."""
    return world_size() > 1


def barrier() -> None:
    if active():
        tdist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the backward sums the incoming gradient over ranks."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        tdist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        tdist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (``x`` itself in a world of one). With
    autograd: the gradient of ``x`` is the rank-sum of the output's."""
    if not active():
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduceSum.apply(x)
    out = x.detach().clone()
    tdist.all_reduce(out)
    return out


def all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """Sum every parameter's ``.grad`` over the ranks in one flattened
    all-reduce, in place. A parameter without a gradient on a rank counts as
    zeros there; it keeps ``None`` where no rank has one (the optimizer then
    leaves it, as the one-process step does). A no-op in a world of one."""
    if not active():
        return
    params = list(params)
    if not params:
        return
    ref = params[0]
    present = [p.grad is not None for p in params]
    flat = torch.cat([torch.tensor(present, dtype=torch.float32, device=ref.device)] + [
        (p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float()
        for p in params])
    tdist.all_reduce(flat)
    present = flat[:len(params)].tolist()  # the ranks' flags, read in one transfer
    offset = len(params)
    for p, has in zip(params, present):
        n = p.numel()
        if has:
            part = flat[offset:offset + n].view_as(p)
            if p.grad is None:
                p.grad = part.to(p.dtype)
            else:
                p.grad.copy_(part)
        offset += n


def broadcast_module(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` as rank 0 holds it."""
    if not active():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            tdist.broadcast(t.data, 0)


def same_on_every_rank(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether every rank holds these tensors bit for bit (their float64 sums
    and max |values| compared across ranks: a check, not a proof)."""
    if not active():
        return True
    sig = torch.stack([torch.stack([t.detach().double().sum(), t.detach().double().abs().max()])
                       for t in tensors]).reshape(-1)
    lo, hi = sig.clone(), sig.clone()
    tdist.all_reduce(lo, op=tdist.ReduceOp.MIN)
    tdist.all_reduce(hi, op=tdist.ReduceOp.MAX)
    return bool(torch.equal(lo, hi))


def gather_host(obj) -> List:
    """``obj`` (any picklable host value) of every rank, in rank order."""
    if not active():
        return [obj]
    out = [None] * world_size()
    tdist.all_gather_object(out, obj)
    return out


def proc_dir(output_dir: str) -> str:
    """This rank's own output directory ``{output_dir}/proc{rank}`` in a
    world of more than one (each rank scores the gathered results and
    writes its results file there, as the JAX ``validate`` does), else
    ``output_dir``."""
    if not active():
        return output_dir
    return os.fspath(Path(output_dir) / f"proc{rank()}")
