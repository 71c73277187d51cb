"""Look for MKL's faulty first call: one op's first multi-threaded call on a
fresh CPU process, against float64.

torch sends ``exp``, ``log`` and ``tanh`` of CPU float tensors to MKL's vector
math, whose first multi-threaded call in a process has been seen to return
values up to 9e-5 off on one thread's share of the tensor, about one process
in a hundred; ``exp2`` and ``log2`` run torch's own kernels. Each process makes
one call, so the loop below makes one first call per process:

    for op in log log2 exp exp2; do for s in $(seq 1 300); do echo $op $s; done; done \\
        | xargs -P 6 -n 2 python tests/mkl_first_call.py > calls.txt
    awk '$4 > 0' calls.txt      # processes with an element off by more than 1e-6 relative

Each line is ``op seed max_relative_error elements_above_1e-6``. Two threads,
a [2, 18, 13, 32] float32 tensor, as the fault was first measured.
"""

import sys

import numpy as np
import torch


def main(op: str, seed: int) -> None:
    torch.set_num_threads(2)
    rng = np.random.RandomState(seed)
    lo, hi = (1e-6, 2.0) if op.startswith("log") else (-20.0, 0.0)
    x = rng.uniform(lo, hi, (2, 18, 13, 32)).astype(np.float32)
    y = getattr(torch, op)(torch.from_numpy(x)).numpy().astype(np.float64)
    ref = getattr(np, op)(x.astype(np.float64))
    err = np.abs(y - ref) / np.maximum(np.abs(ref), 1e-30)
    print(op, seed, float(err.max()), int((err > 1e-6).sum()))


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
