"""Dropout bits of the training kernels, in plain PyTorch.

Two ways to say which elements a training kernel drops, as in the JAX
package (``ops/pallas/prng.py``):

* **bits**: an explicit uint32 tensor, the element dropped where
  ``bits < threshold(rate)``. Tests hand the same bits to the JAX kernels and
  to the port. A bits tensor is int32 holding the uint32 pattern (numpy's
  ``bits.view(np.int32)``), or int64 in ``[0, 2^32)``.
* **seed**: Philox4x32-10 keyed by ``(seed, offset)`` and counted by
  ``(c0, c1, c2, 0)``, word 0 of the output; ``csrc/philox.cuh`` is the same
  generator inside the kernels. :func:`philox_bits` computes it with int64
  tensor ops whose products never exceed 2^48, so the plain versions drop
  exactly the elements the kernels drop, on the CPU and on the card.

The TPU's own generator (``pltpu.prng_random_bits``) is not reproduced: the
JAX kernels' seed-mode streams differ from these, as they differ from torch's.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments


def threshold(rate: float) -> int:
    """uint32 threshold t with P(bits < t) = rate (``ops/pallas/prng.py:23``)."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return min(int(round(rate * 4294967296.0)), 4294967295)


def _mulhilo(x, m: int):
    """(hi, lo) 32-bit words of ``x * m`` for int64 ``x`` in [0, 2^32)."""
    t_hi = (x >> 16) * m
    t_lo = (x & 0xFFFF) * m
    lo = (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK
    hi = (t_hi + (t_lo >> 16)) >> 16
    return hi, lo


def philox4x32(key, counter, rounds: int = 10):
    """Philox4x32 (Salmon et al., SC'11): ``key`` two ints, ``counter`` four
    int64 tensors (or ints) in [0, 2^32); returns the four output words."""
    k0, k1 = (int(k) & _MASK for k in key)
    dev = next((c.device for c in counter if isinstance(c, torch.Tensor)), None)
    x0, x1, x2, x3 = torch.broadcast_tensors(*(torch.as_tensor(c, dtype=torch.int64, device=dev)
                                               for c in counter))
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(x0, _M0)
        hi1, lo1 = _mulhilo(x2, _M1)
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return x0, x1, x2, x3


def philox_bits(seed: int, offset: int, c0, c1, c2):
    """Word 0 of Philox4x32-10 at counter ``(c0, c1, c2, 0)``, int64 in [0, 2^32)."""
    return philox4x32((seed, offset), (c0, c1, c2, 0))[0]


def as_unsigned(bits):
    """A bits tensor (int32 pattern or int64) as int64 values in [0, 2^32)."""
    if bits.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"dropout bits must be int32 (the uint32 pattern) or int64, "
                         f"got {bits.dtype}")
    return bits.to(torch.int64) & _MASK


def as_words(bits):
    """A bits tensor as contiguous int32 words (the uint32 pattern) for a kernel."""
    u = as_unsigned(bits)
    return torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).contiguous()


def keep_mask(bits, rate: float):
    """Survivors: ``bits >= threshold(rate)`` (``ops/pallas/prng.py:29``)."""
    return as_unsigned(bits) >= threshold(rate)


def check_mode(rate: float, bits, seed) -> str:
    """'none' (rate 0), 'bits' or 'seed'; raises on a rate with neither."""
    threshold(rate)
    if rate == 0.0:
        return "none"
    if bits is not None:
        return "bits"
    if seed is None:
        raise ValueError("dropout rate > 0 needs dropout_bits or dropout_seed")
    return "seed"


_MODE_CODES = {"none": 0, "bits": 1, "seed": 2}


def kernel_args(mode: str, rate: float, seed, offset: int):
    """The kernels' dropout arguments after the bits pointers: the seed and
    offset key words, the threshold, ``1 / (1 - rate)`` and the mode code."""
    on = mode != "none"
    return (int(seed or 0) & _MASK, int(offset) & _MASK, threshold(rate) if on else 0,
            1.0 / (1.0 - rate) if on else 1.0, _MODE_CODES[mode])
