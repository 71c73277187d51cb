"""``Predictor.call_sharded``: data-parallel serving over a list of devices.

As the JAX ``tests/test_serving.py::test_data_parallel_serving``: the call
over two devices (``["cpu", "cpu"]`` here, each running its half of the
rows on its replica) equals the whole call (1e-4; the halves run the
convolutions at another batch size), and a batch that does not divide by
the number of devices raises. A predictor over an artifact's programs
serves on their device only, and the rows it hands each program are the
call's rows in order.
"""

import numpy as np
import pytest
import torch

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.serving import Predictor, _header

torch.set_num_threads(2)

B, N, RAW_H, RAW_W = 4, 3, 96, 128


def _args(seed=3):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 255, (B, RAW_H, RAW_W, 3), dtype=np.uint8)
    affs = np.tile(np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32), (B, N, 1, 1))
    affs[:, :, :, 2] += rng.uniform(0, 20, (B, N, 2)).astype(np.float32)
    rects = np.tile(np.array([4, 4, 44, 60], np.float32), (B, N, 1))
    valid = rng.random((B, N)) < 0.7
    valid[:, 0] = True
    cent = np.tile(np.array([24.0, 32.0], np.float32), (B * N, 1))
    scal = np.full((B * N, 2), 0.3, np.float32)
    return imgs, affs, rects, affs.copy(), valid, cent, scal


@pytest.fixture(scope="module")
def predictor():
    cfg = presets.tiny_test_config(5)
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(1))
    return Predictor(model, cfg, [[1, 2], [3, 4]], batch_images=B, n_buckets=(N,),
                     raw_hw=(RAW_H, RAW_W))


def test_call_sharded_matches_the_whole_call(predictor):
    args = _args()
    want = predictor.call_raw(*args)
    got = predictor.call_sharded(["cpu", "cpu"], *args)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)
    four = predictor.call_sharded(["cpu"] * 4, *args)
    for g, w in zip(four, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-4)


def test_call_sharded_refuses_an_uneven_split(predictor):
    with pytest.raises(ValueError, match="not divisible"):
        predictor.call_sharded(["cpu"] * 3, *_args())


def test_an_artifacts_programs_serve_on_their_device_only():
    seen = []

    def program(*args):
        seen.append([a.clone() for a in args])
        b = args[0].shape[0]
        return torch.full((b * N, 5, 2), float(b)), args[5][:, :1].expand(b * N, 5)[..., None]

    header = _header(presets.tiny_test_config(5), B, (N,), (RAW_H, RAW_W))
    pred = Predictor.from_programs(header, [program], "cpu")
    args = _args()
    coords, maxvals = pred.call_sharded(["cpu", "cpu"], *args)
    assert len(seen) == 2 and all(s[0].shape[0] == B // 2 for s in seen)
    for i, a in enumerate(args):
        np.testing.assert_array_equal(torch.cat([s[i] for s in seen]).numpy(), a)
    assert torch.equal(coords, torch.full((B * N, 5, 2), float(B // 2)))
    assert torch.equal(maxvals[:, 0, 0], torch.from_numpy(args[5][:, 0]))
    with pytest.raises(ValueError, match="serve on cpu"):
        pred.call_sharded(["cpu", "meta"], *args)
