"""The port's serving artifact of the tiny W48 model: exported with the
kernels' ``i2r::`` ops in its graph, saved, loaded, served.

* against the JAX artifact of the same weights (``i2rnet_tpu.serving``
  ``export_predictor`` with ``use_pallas=False`` on the CPU, then
  ``load_predictor``) on uniform and ragged calls with a fully padded image:
  coordinates within 1e-3 px, confidences atol 1e-5 / rtol 1e-4, the bound of
  ``tests/test_torch_serving.py``. Both artifacts decode by argmax
  (``TEST.POST_PROCESS`` false): that file holds the DARK step of the same
  serve function against JAX, and explains why random-weight heatmaps need
  the argmax reference there;
* against the port's in-process ``Predictor``: bit-equal (on the CPU the ops
  run the kernels' plain versions, the same PyTorch calls in the same order;
  ``tests/test_torch_serving_ops.py`` serves an artifact in a fresh process);
* the graph's ops, the routing and chunking of the loaded predictor, the
  header's validation, and ``MicroBatcher``.
"""

import json
import struct
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from i2rnet_tpu import serving as jax_serving
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.ops.cuda.library import graph_ops
from i2rnet_tpu_torch.serving import (MicroBatcher, Predictor, export_predictor,
                                      load_predictor, save_artifact)
from test_torch_bridge import port_model, random_variables, tiny_jax_model
from test_torch_serving import _batch

torch.set_num_threads(2)

B, BUCKETS, RAW_HW = 2, (2, 3), (96, 128)
FLIP_PAIRS = [[1, 2], [3, 4]]  # COCO's pairs within K=5
KERNEL_OPS = ["i2r::conv_epilogue", "i2r::encoder_ffn", "i2r::masked_mhsa"]


def _jax_cfg():
    cfg, jmodel = tiny_jax_model(use_pallas=False)
    cfg.DATASET.DATASET = "coco"  # the flip pairs export_predictor looks up
    cfg.TEST.POST_PROCESS = False
    cfg.TEST.BLUR_KERNEL = 5
    return cfg, jmodel


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(port config, port model with the kernel routes on, its artifact's
    path and predictor, the JAX artifact's path and predictor)."""
    jcfg, jmodel = _jax_cfg()
    variables = random_variables(jmodel, jcfg, seed=3)
    cfg = presets.from_config(jcfg)
    model = port_model(variables, jcfg, use_kernels=True)
    tmp = tmp_path_factory.mktemp("artifact")
    path, jpath = str(tmp / "w48.i2rx"), str(tmp / "w48_jax.i2rx")
    save_artifact(path, *export_predictor(cfg, model, B, BUCKETS, RAW_HW, device="cpu"))
    jax_serving.save_artifact(jpath, *jax_serving.export_predictor(
        jcfg, variables, B, BUCKETS, RAW_HW, platforms=["cpu"], use_pallas=False))
    return (cfg, model, path, load_predictor(path, device="cpu"), jpath,
            jax_serving.load_predictor(jpath))


def _requests(rng):
    """Three images, 5 + 1 + 0 (the whole image) boxes: rows of 3 + 2, 1, 1."""
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((80, 120), (64, 64), (96, 128))]
    boxes = [[[5.0 + 7 * i, 4.0 + 3 * i, 35.0, 50.0] for i in range(5)],
             [[2.0, 2.0, 30.0, 40.0]], []]
    return images, boxes


@pytest.mark.parametrize("n_per_image", [(3, 3), (2, 0)], ids=["uniform", "ragged"])
def test_artifact_matches_the_jax_artifact(served, rng, n_per_image):
    _, _, _, pred, _, jpred = served
    args = _batch(rng, n_per_image, BUCKETS[-1])
    coords, maxvals = (t.numpy() for t in pred.call_raw(*args))
    jcoords, jmaxvals = map(np.asarray, jpred.call_raw(*args))
    padded = ~args[4].reshape(-1)
    assert coords.shape == (B * 3, 5, 2) and np.isfinite(coords).all()
    assert not coords[padded].any() and not maxvals[padded].any()
    np.testing.assert_allclose(coords, jcoords, atol=1e-3, rtol=0)
    np.testing.assert_allclose(maxvals, jmaxvals, atol=1e-5, rtol=1e-4)


def test_artifact_requests_match_jax_and_in_process(served, rng):
    """Whole requests (routed, chunked, padded): bit-equal to the port's
    in-process Predictor of the same model, and within the bound of the JAX
    artifact's Predictor."""
    cfg, model, _, pred, _, jpred = served
    images, boxes = _requests(rng)
    got = pred.predict(images, boxes)
    local = Predictor(model, cfg, FLIP_PAIRS, batch_images=B, n_buckets=BUCKETS,
                      raw_hw=RAW_HW).predict(images, boxes)
    for g, w, j in zip(got, local, jpred.predict(images, boxes)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(g[..., :2], j[..., :2], atol=1e-3, rtol=0)
        np.testing.assert_allclose(g[..., 2], j[..., 2], atol=1e-5, rtol=1e-4)


def test_graph_holds_the_kernel_ops(served):
    """Every bucket's program calls Kernels A and B as ``i2r::`` ops, once per
    layer and forward (2 layers, flip test), and the conv epilogue once per
    conv unit of the trunk and forward (37 units). The ``--no-kernels``
    artifact, with none, is ``tests/test_torch_hub_demo.py``'s."""
    _, _, _, pred, _, _ = served
    assert pred.header["kernels"] == KERNEL_OPS
    for n in BUCKETS:
        graph = pred.programs[n].graph
        assert graph_ops(graph) == KERNEL_OPS
        calls = [str(node.target) for node in graph.nodes if node.op == "call_function"]
        assert calls.count("i2r.masked_mhsa.default") == 4
        assert calls.count("i2r.encoder_ffn.default") == 4
        assert calls.count("i2r.conv_epilogue.default") == 2 * 37


def test_loaded_predictor_routes_and_chunks(served):
    """Rows go to the smallest bucket that holds them (5 boxes: 3 + 2, more
    than the largest bucket); each answer is the one the image gets alone in
    a batch of one (images share no computation; padded persons are masked
    keys), up to f32 noise."""
    cfg, model, _, pred, _, _ = served
    calls = []
    serve = pred.serve
    pred.serve = lambda *a: calls.append(tuple(a[4].shape)) or serve(*a)
    try:
        images, boxes = _requests(np.random.RandomState(3))
        out = pred.predict(images, boxes)
    finally:
        pred.serve = serve
    assert [o.shape for o in out] == [(5, 5, 3), (1, 5, 3), (1, 5, 3)]
    assert sorted(calls) == [(2, 2), (2, 2), (2, 3)]
    alone = Predictor(model, cfg, FLIP_PAIRS, batch_images=1, n_buckets=BUCKETS,
                      raw_hw=RAW_HW).predict(images, boxes)
    for got, ref in zip(out, alone):
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def _rewrite_header(path, dst, edit):
    data = Path(path).read_bytes()
    (hlen,) = struct.unpack("<I", data[4:8])
    header = json.loads(data[8:8 + hlen])
    edit(header)
    hdr = json.dumps(header).encode()
    Path(dst).write_bytes(b"I2RX" + struct.pack("<I", len(hdr)) + hdr + data[8 + hlen:])
    return str(dst)


def test_header_validation(served, tmp_path):
    """Bad magic; each package's reader refuses the other's file; an artifact
    serves only on the device it was exported for."""
    _, _, path, _, jpath, _ = served
    bad = tmp_path / "bad.i2rx"
    bad.write_bytes(b"NOPE" + b"\x00" * 16)
    with pytest.raises(ValueError, match="not an i2rx artifact"):
        load_predictor(str(bad), device="cpu")
    with pytest.raises(ValueError, match="unsupported artifact format 1, written by the JAX"):
        load_predictor(jpath, device="cpu")
    with pytest.raises(ValueError, match="unsupported artifact format 'torch-export-1'"):
        jax_serving.load_predictor(path)
    with pytest.raises(ValueError, match="exported for 'cpu', asked to serve on 'cuda'"):
        load_predictor(path)  # the card by default
    moved = _rewrite_header(path, tmp_path / "cuda.i2rx", lambda h: h.update(device="cuda"))
    with pytest.raises(ValueError, match="exported for 'cuda', asked to serve on 'cpu'"):
        load_predictor(moved, device="cpu")


def _spy(pred):
    calls, lock = [], threading.Lock()
    predict = pred.predict

    def spy(images, boxes):
        with lock:
            calls.append(len(images))
        return predict(images, boxes)

    pred.predict = spy
    return calls, predict


def test_micro_batcher_coalesces_and_matches(served):
    """Concurrent submits go out in fewer predict calls than requests, and
    every future holds what a sequential predict of its request gives."""
    _, _, _, pred, _, _ = served
    rng = np.random.RandomState(4)
    reqs = [(rng.randint(0, 256, (64, 96, 3)).astype(np.uint8),
             [[4.0 + i, 2.0, 40.0, 56.0]] * (1 + i % 3)) for i in range(6)]
    calls, predict = _spy(pred)
    mb = MicroBatcher(pred, max_delay_ms=200.0)
    try:
        futs = [mb.submit(img, bxs) for img, bxs in reqs]
        got = [f.result(timeout=120) for f in futs]
    finally:
        mb.close()
        pred.predict = predict
    assert sum(calls) == len(reqs) and len(calls) < len(reqs) and max(calls) == B
    for (img, bxs), g in zip(reqs, got):
        np.testing.assert_array_equal(g, predict([img], [bxs])[0])


def test_micro_batcher_errors_and_close(served):
    """A failed call's exception reaches every waiter of that call; close()
    dispatches what is pending; a later submit raises."""
    _, _, _, pred, _, _ = served
    mb = MicroBatcher(pred, max_delay_ms=500.0)
    try:
        bad = [mb.submit(np.zeros((4, 4, 3), np.float32), []) for _ in range(B)]
        for fut in bad:
            with pytest.raises(ValueError, match="uint8"):
                fut.result(timeout=60)
    finally:
        mb.close()
    calls, predict = _spy(pred)
    mb = MicroBatcher(pred, max_delay_ms=60_000.0)  # nothing leaves before close
    try:
        img = np.random.RandomState(5).randint(0, 256, (64, 96, 3)).astype(np.uint8)
        pending = mb.submit(img, [[4.0, 2.0, 40.0, 56.0]])
        assert not pending.done()
        mb.close()
        assert calls == [1] and pending.result(timeout=0).shape == (1, 5, 3)
        with pytest.raises(RuntimeError, match="closed"):
            mb.submit(img, [])
    finally:
        pred.predict = predict
