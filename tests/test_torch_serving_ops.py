"""The six eval kernels as registered ``i2r::`` ops, and the artifact of the
tiny HRFormer two-stage model on the E + F route.

* ``torch.library.opcheck`` on each op at small CPU shapes: the schema, the
  fake implementation against the real one (the kernel's plain version on
  the CPU), and the op under ``aot_dispatch``;
* the model's kernel routes call the wrappers eagerly and the ops only while
  ``torch.export`` traces;
* the HRT artifact: its programs call Kernels E and F (and A and B in the
  inter encoder) as ops, once per block and forward, with the blocks' packed
  weights as constants of the program, not computed at each call; it serves
  what the in-process ``Predictor`` serves, bit for bit, also in a fresh
  process that cannot import ``jax``, ``yaml``, ``cv2`` or the JAX package
  and never imports the model classes.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.ops.cuda import hrformer_block as hb
from i2rnet_tpu_torch.ops.cuda import library
from i2rnet_tpu_torch.ops.cuda import mlp_dwbn as mb
from i2rnet_tpu_torch.serving import Predictor, export_predictor, load_predictor, save_artifact

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
B, N, RAW_HW = 2, 2, (96, 128)
HRT_OPS = ["i2r::encoder_ffn", "i2r::masked_mhsa", "i2r::mlp_block", "i2r::window_attn_block"]


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32))


def _attn_weights(rng, c):
    return [_t(rng, *s, scale=0.3) for s in ((c,), (c,), (c, c), (c,), (c, c), (c,), (c, c), (c,),
                                            (c, c), (c,))]


def _mlp_weights(rng, c, d):
    return [_t(rng, d, c, scale=0.3), _t(rng, d, scale=0.1), _t(rng, d, 3, 3, scale=0.3),
            _t(rng, d, scale=0.1), _t(rng, c, d, scale=0.3), _t(rng, c, scale=0.1)]


def _op_cases():
    rng = np.random.RandomState(0)
    c, d, heads = 8, 16, 2
    q, k, v = (_t(rng, 2, 5, c) for _ in range(3))
    mask = torch.tensor([[False] * 5, [False, False, False, True, True]])
    x = _t(rng, 2, 9, 10, c)
    ln_a, attn = _attn_weights(rng, c)[:2], _attn_weights(rng, c)[2:]
    ln_m, mlp = [_t(rng, c), _t(rng, c, scale=0.1)], _mlp_weights(rng, c, d)
    pa = list(hb.pack_attn(*attn, heads, torch.float32, "cpu"))
    pm = list(mb.pack_mlp(*mlp, torch.float32, "cpu"))
    ffn = [_t(rng, c), _t(rng, c, scale=0.1), _t(rng, d, c, scale=0.3), _t(rng, d, scale=0.1),
           _t(rng, c, d, scale=0.3), _t(rng, c, scale=0.1), _t(rng, c), _t(rng, c, scale=0.1)]
    return {
        "masked_mhsa": (q, k, v, heads, mask),
        "encoder_ffn": (q, *ffn, 1e-5),
        "window_attn_block": (x, *ln_a, *attn, heads, 7, 1e-6, pa),
        "mlp_block": (x, *ln_m, *mlp, 1e-6, pm),
        "full_block": (x, *ln_a, *attn, *ln_m, *mlp, heads, 7, 1e-6, pa + pm),
        "mlp_dwbn": (x, *mlp, list(mb.pack_mlp32(*mlp, "cpu"))),
    }


@pytest.mark.parametrize("name", list(library.ROUTES))
def test_opcheck(name):
    """The op's fake output (shape, dtype, strides) is the real one's, its
    schema holds (no input mutated or aliased), and it traces under
    ``aot_dispatch``; its CPU result is the kernel's plain version's."""
    op = getattr(torch.ops.i2r, name).default
    args = _op_cases()[name]
    torch.library.opcheck(op, args)
    wrapper = library.ROUTES[name][0]
    # the wrappers take the packed weights apart from the op's list; on the
    # CPU they compute the plain version from the weights themselves
    want = wrapper(*args) if name in ("masked_mhsa", "encoder_ffn") else wrapper(*args[:-1])
    torch.testing.assert_close(op(*args), want, rtol=0, atol=0)


def test_routes_take_the_ops_only_while_exporting(monkeypatch):
    for name, (wrapper, op) in library.ROUTES.items():
        assert library.route(name) is wrapper
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
        assert library.route(name) is op
        monkeypatch.undo()


@pytest.fixture(scope="module")
def hrt(tmp_path_factory):
    """(config, the tiny HRT model on the E + F route, its artifact's path
    and predictor)."""
    cfg = presets.tiny_hrt_config(5)
    cfg["DATASET"]["DATASET"] = "coco"
    cfg["DEVICE"]["USE_KERNELS"] = True
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    with torch.no_grad():  # BN statistics away from the identity
        for name, t in model.named_buffers():
            if name.endswith("running_mean"):
                t.normal_(0.0, 0.1)
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.5)
    path = str(tmp_path_factory.mktemp("hrt") / "hrt.i2rx")
    save_artifact(path, *export_predictor(cfg, model, B, N, RAW_HW, device="cpu"))
    return cfg, model, path, load_predictor(path, device="cpu")


def _requests():
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in ((80, 120), (96, 128))]
    return images, [[[5.0 + 7 * i, 4.0 + 3 * i, 35.0, 50.0] for i in range(3)], []]


def test_hrt_artifact_holds_the_kernel_ops_and_packed_constants(hrt):
    """Kernels E and F once per HRFormer block and forward (9 blocks, flip
    test), A and B once per inter layer and forward; every packed weight of
    an E or F node is a constant of the program (a ``get_attr`` of the loaded
    module), six per node."""
    _, model, _, pred = hrt
    blocks = len(model.singleformer.blocks())
    assert pred.header["kernels"] == HRT_OPS
    graph = pred.programs[N].graph
    assert library.graph_ops(graph) == HRT_OPS
    nodes = [node for node in graph.nodes if node.op == "call_function"]
    for name, count in (("window_attn_block", 2 * blocks), ("mlp_block", 2 * blocks),
                        ("masked_mhsa", 4), ("encoder_ffn", 4)):
        assert sum(str(node.target) == f"i2r.{name}.default" for node in nodes) == count
    for node in nodes:
        if str(node.target) in ("i2r.window_attn_block.default", "i2r.mlp_block.default"):
            packed = node.kwargs.get("packed", node.args[-1])
            assert len(packed) == 6 and all(p.op == "get_attr" for p in packed)


def test_hrt_artifact_serves_as_in_process_and_in_a_fresh_process(hrt, tmp_path):
    cfg, model, path, pred = hrt
    images, boxes = _requests()
    got = pred.predict(images, boxes)
    want = Predictor(model, cfg, presets.COCO_FLIP_PAIRS[:2], batch_images=B, n_buckets=(N,),
                     raw_hw=RAW_HW).predict(images, boxes)
    assert [g.shape for g in got] == [(3, 5, 3), (1, 5, 3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert max(np.abs(g[..., 2]).max() for g in got) > 0
    np.savez(tmp_path / "req.npz", *images)
    code = (
        "import json, sys\n"
        "for m in ('jax', 'flax', 'yaml', 'cv2', 'i2rnet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(2)  # as this process: the CPU products split alike\n"
        "from i2rnet_tpu_torch.serving import load_predictor\n"
        f"pred = load_predictor({path!r}, device='cpu')\n"
        f"req = np.load({str(tmp_path / 'req.npz')!r})\n"
        f"out = pred.predict([req['arr_0'], req['arr_1']], json.loads({json.dumps(boxes)!r}))\n"
        f"np.savez({str(tmp_path / 'out.npz')!r}, *out)\n"
        "assert not any(k.startswith('i2rnet_tpu_torch.models') for k in sys.modules)\n"
        "print('ok', pred.header['kernels'])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith(f"ok {HRT_OPS}")
    out = np.load(tmp_path / "out.npz")
    for i, w in enumerate(got):
        np.testing.assert_array_equal(out[f"arr_{i}"], w)


def test_export_needs_the_packed_weights():
    """A block on a kernel route that was not prepared refuses to be traced:
    packing fake parameters would put the packing into every call."""
    from i2rnet_tpu_torch.models.hrformer import HRFormerBlock

    blk = HRFormerBlock(16, 2, 7, 2.0).eval()
    blk.use_kernels = True
    with pytest.raises(RuntimeError, match="prepare_export"):
        torch.export.export(blk, (torch.zeros(1, 7, 7, 16),))
    blk.prepare_export(torch.float32, torch.device("cpu"))
    ep = torch.export.export(blk, (torch.zeros(1, 7, 7, 16),))
    assert library.graph_ops(ep.graph) == ["i2r::mlp_block", "i2r::window_attn_block"]
