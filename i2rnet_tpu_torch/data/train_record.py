"""A record of training batches that a fixture can hold and a card can check.

``expected_train.json`` beside each training split under ``data/fixtures``
holds what the JAX package's ``train_batches`` + ``make_raw_batch`` give for
the first batches of epoch 0 (``tests/torch_fixture.py`` writes it).
:func:`train_records` makes the same record from the port's trainer
(``core/trainer.py::epoch_batches`` at ``WORKERS`` 0) and
:func:`compare_records` holds one against the other: the items and buckets
equal, the SHA-256 of ``images``, ``person_valid`` and ``joints_vis``
equal, and the float arrays within ``atol``.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

import numpy as np

from i2rnet_tpu_torch.core.trainer import epoch_batches

DIGESTS = ("images", "person_valid", "joints_vis")
FLOATS = ("crop_affines", "mask_affines", "boxes", "joints_hm")


def batch_record(items, n_bucket: int, raw: Dict[str, np.ndarray]) -> Dict:
    """One raw batch as JSON data: its items, bucket, digests and floats."""
    return {
        "items": [[int(i), [int(p) for p in persons]] for i, persons in items],
        "n_bucket": int(n_bucket),
        "sha256": {k: hashlib.sha256(np.ascontiguousarray(raw[k]).tobytes()).hexdigest()
                   for k in DIGESTS},
        **{k: np.asarray(raw[k], np.float64).tolist() for k in FLOATS},
    }


def train_records(cfg: Dict, dataset, batch_images: int, n_batches: int,
                  epoch: int = 0) -> List[Dict]:
    """The first ``n_batches`` of ``epoch`` as ``train_loop`` makes them at
    ``WORKERS`` 0, the global ``np.random`` (the half-body choice) seeded
    with ``SEED`` first."""
    seen = []
    make = dataset.make_raw_batch

    def spy(items, n_bucket, rng=None):
        seen.append((items, n_bucket))
        return make(items, n_bucket, rng)

    dataset.make_raw_batch = spy
    np.random.seed(cfg["SEED"])
    records = []
    try:
        batches = epoch_batches({**cfg, "WORKERS": 0}, dataset, epoch, batch_images)
        for raw in batches:
            records.append(batch_record(*seen[len(records)], raw))
            if len(records) == n_batches:
                break
    finally:
        del dataset.make_raw_batch
    return records


def compare_records(got: List[Dict], want: List[Dict], atol: float = 1e-5) -> float:
    """Raise AssertionError where ``got`` and ``want`` differ; return the
    largest float difference."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} batches vs {len(want)}")
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("items", "n_bucket", "sha256"):
            if g[k] != w[k]:
                raise AssertionError(f"batch {i}: {k} {g[k]} vs {w[k]}")
        for k in FLOATS:
            a, b = np.asarray(g[k]), np.asarray(w[k])
            if a.shape != b.shape:
                raise AssertionError(f"batch {i}: {k} shape {a.shape} vs {b.shape}")
            diff = float(np.abs(a - b).max(initial=0.0))
            if not diff <= atol:
                raise AssertionError(f"batch {i}: {k} differs by {diff} (> {atol})")
            worst = max(worst, diff)
    return worst
