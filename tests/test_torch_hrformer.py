"""The HRFormer I²R-Net port (``models/hrformer.py``, ``models/interformer.py``)
vs the JAX modules, on the CPU, float32, weights carried by ``params_from_jax``.

Each JAX module gets seeded numpy weights (convs and denses scaled by their
fan-in, BN statistics non-trivial, so the folds are exercised), and the port
module of the same place in the two-stage model takes them through the bridge.
"Kernels on" runs the port's kernel routes, which on CPU tensors are the
plain versions of Kernels E, F, G and 7, against the JAX model's fused routes
(Pallas in interpret mode); "off" is the unfused module path on both sides.

Tolerance: atol 1e-5 / rtol 1e-4 for modules; the whole models' heatmaps
within 1e-4 of their largest magnitude (two frameworks' f32 conv and matmul
orders through some 30 layers). Padded persons are exactly 0 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2rnet_tpu.models.hrformer import HRFormer as JaxHRFormer
from i2rnet_tpu.models.hrformer import HRFormerBlock as JaxBlock
from i2rnet_tpu.models.hrformer import HRTFuse as JaxFuse
from i2rnet_tpu.models.hrformer import MlpDWBN as JaxMlp
from i2rnet_tpu.models.hrformer import WindowRPEAttention as JaxAttention
from i2rnet_tpu.models.hrformer import _rpe_index as jax_rpe_index
from i2rnet_tpu.models.hrformer import window_partition as jax_partition
from i2rnet_tpu.models.interformer import InterFormer as JaxInterFormer
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.models.hrformer import (HRFormer, HRFormerBlock, HRTModule, MlpDWBN,
                                              WindowRPEAttention, _rpe_index)
from i2rnet_tpu_torch.models.encoder import WindowInterEncoder
from i2rnet_tpu_torch.models.interformer import InterFormer, build_model
from i2rnet_tpu_torch.models.layers import upsample_bilinear
from i2rnet_tpu_torch.models.pure_multi import PureMultiInterFormer
from i2rnet_tpu_torch.ops.cuda import launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.hrformer_block import window_partition, window_unpartition

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
MODEL_REL = 1e-4
TINY_ARCH = presets.TINY_HRFORMER_ARCH  # tests/test_hrformer.py:21
T = torch.from_numpy
BLOCK = "singleformer/stage2/m0_b0_blk0"
PORT_BLOCK = "singleformer.backbone.stage2.0.branches.0.0."


def fill(shapes, seed):
    """Seeded numpy values for a JAX variable tree's shapes."""
    rng = np.random.RandomState(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            v = rng.randn(*s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        else:  # bias, mean, rpe_table
            v = 0.1 * rng.randn(*s.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def init(module, *args, seed=0, **kw):
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kw))
    return fill(shapes, seed)


def port_weights(variables, jax_path, port_prefix):
    """``variables`` of a JAX module placed at ``jax_path`` of the two-stage
    model, through ``params_from_jax``, keyed relative to ``port_prefix``."""
    def nest(tree):
        for part in reversed(jax_path.split("/")):
            tree = {part: tree}
        return tree

    sd = params_from_jax({k: nest(v) for k, v in variables.items()}, "interformer")
    assert all(k.startswith(port_prefix) for k in sd), sorted(sd)[:3]
    return {k[len(port_prefix):]: v for k, v in sd.items()}


def load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def test_rpe_index_and_partition_round_trip(rng):
    np.testing.assert_array_equal(_rpe_index(7), jax_rpe_index(7))
    x = rng.rand(2, 16, 12, 8).astype(np.float32)
    win, info = window_partition(T(x), 7)
    ref, ref_info = jax_partition(jnp.asarray(x), 7)
    assert tuple(win.shape) == (2 * 3 * 2, 49, 8) and info == ref_info
    np.testing.assert_array_equal(win.numpy(), np.asarray(ref))
    assert torch.equal(window_unpartition(win, 7, info), T(x))


def test_window_rpe_attention_matches_jax(rng):
    x = rng.randn(6, 49, 16).astype(np.float32)
    jm = JaxAttention(num_heads=2, window=7, dtype=jnp.float32)
    v = init(jm, x)
    ref = np.asarray(jm.apply(v, x))
    port = load(WindowRPEAttention(16, 2, 7), port_weights(v, BLOCK + "/attn", PORT_BLOCK + "attn.attn."))
    with torch.no_grad():
        got = port(T(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_mlp_dwbn_eval_matches_jax(rng):
    x = (rng.rand(2, 8, 6, 16) * 2 - 1).astype(np.float32)
    jm = JaxMlp(hidden=32, out=16, dtype=jnp.float32)
    v = init(jm, x, train=False)
    ref = np.asarray(jm.apply(v, x, train=False))
    port = load(MlpDWBN(16, 32), port_weights(v, BLOCK + "/mlp", PORT_BLOCK + "mlp."))
    with torch.no_grad():
        got = port(T(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


#: the eval routes: modules ("off"), Kernels E + F ("block", JAX
#: ``fused_eval_block``), kernel 7 ("onepass", JAX ``fused_eval_block`` and
#: ``fused_eval_onepass``) and Kernel G ("mlp", JAX ``fused_eval_mlp``)
ROUTES = ["off", "block", "onepass", "mlp"]
FUSED_BLOCK_ROUTES = ("block", "onepass")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("h,w,c,heads", [(18, 13, 16, 2), (14, 14, 32, 4), (7, 6, 24, 3)])
def test_hrformer_block_matches_jax(rng, route, h, w, c, heads):
    """The block's four eval routes (``ROUTES``)."""
    x = (rng.rand(2, h, w, c) * 2 - 1).astype(np.float32)
    jm = JaxBlock(channels=c, num_heads=heads, window=7, mlp_ratio=2.0,
                  fused_eval_block=route in FUSED_BLOCK_ROUTES,
                  fused_eval_onepass=route == "onepass", fused_eval_mlp=route == "mlp",
                  dtype=jnp.float32)
    v = init(jm, x, train=False, seed=c)
    ref = np.asarray(jax.jit(lambda x_: jm.apply(v, x_, train=False))(x))
    port = load(HRFormerBlock(c, heads, 7, 2.0), port_weights(v, BLOCK, PORT_BLOCK))
    port.use_kernels = route != "off"
    port.fused_block = route in FUSED_BLOCK_ROUTES
    port.fused_onepass = route == "onepass"
    port.fused_mlp = route == "mlp"
    with torch.no_grad():
        got = port(T(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_hrformer_block_is_eval_only(rng, monkeypatch):
    """Every block option runs in both modes: ``use_rpe`` (adding the
    relative-position bias, ``tests/test_torch_options.py`` holds it against
    JAX) in training and in eval, where with every kernel route on it takes
    the modules by rule (the kernel routes, patched to raise, are not
    reached), and changes the output."""
    import i2rnet_tpu_torch.models.hrformer as hrformer

    def no_kernel(*_, **__):
        raise AssertionError("a kernel route was taken under use_rpe")

    monkeypatch.setattr(hrformer, "route", lambda name: no_kernel)
    monkeypatch.setattr(hrformer, "window_attn_block_train_fused", no_kernel)
    x = T((rng.rand(2, 7, 7, 16) * 2 - 1).astype(np.float32))
    for train in (True, False):
        torch.manual_seed(0)
        blk = HRFormerBlock(16, 2, 7, 2.0, use_rpe=True).train(train)
        blk.use_kernels = blk.fused_block = blk.fused_train = True
        torch.nn.init.normal_(blk.attn.attn.relative_position_bias_table)
        with torch.no_grad():
            got = blk(x)
            blk.use_rpe = False
            blk.use_kernels = False
            plain = blk(x)
        assert got.shape == (2, 7, 7, 16) and not torch.allclose(got, plain)
    assert HRFormerBlock(16, 2, 7, 2.0).train()(torch.zeros(1, 7, 7, 16)).shape == (1, 7, 7, 16)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_upsample_bilinear_matches_jax_resize(rng, factor):
    x = rng.randn(2, 3, 5, 4).astype(np.float32)  # NCHW
    ref = jax.image.resize(x.transpose(0, 2, 3, 1), (2, 5 * factor, 4 * factor, 3), "bilinear")
    got = upsample_bilinear(T(x), (5 * factor, 4 * factor)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref).transpose(0, 3, 1, 2), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("multi_scale_output", [True, False])
def test_hrt_fuse_matches_jax(rng, multi_scale_output):
    """Fusion of four branches: 1x1 ConvBN + bilinear up, dw-3x3/s2 chains."""
    ch = [8, 16, 24, 32]
    xs = [rng.randn(2, 16 >> i, 12 >> i, c).astype(np.float32) for i, c in enumerate(ch)]
    jm = JaxFuse(4, ch, multi_scale_output=multi_scale_output, dtype=jnp.float32)
    v = init(jm, xs, None, False)
    ref = jm.apply(v, xs, None, False)
    cfg = dict(num_channels=ch, num_branches=4, num_blocks=(0,), num_heads=(1,) * 4,
               num_window_sizes=(7,) * 4, num_mlp_ratios=(1,) * 4)
    port = HRTModule(cfg, [], multi_scale_output)
    port.fuse_layers.load_state_dict(
        port_weights(v, "singleformer/stage4/m0_fuse", "singleformer.backbone.stage4.0.fuse_layers."))
    with torch.no_grad():
        got = port.eval().fuse([T(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == len(ref) == (4 if multi_scale_output else 1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), np.asarray(r),
                                   rtol=RTOL, atol=ATOL)


def _rel(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("route", ["off", "block", "onepass"])
def test_hrformer_matches_jax(rng, route):
    """Tiny HRFormer (the JAX tests' arch), 64x48: features and heatmaps."""
    x = rng.randn(2, 64, 48, 3).astype(np.float32)
    jm = JaxHRFormer(arch=TINY_ARCH, num_joints=5, fused_eval_block=route in FUSED_BLOCK_ROUTES,
                     fused_eval_onepass=route == "onepass", dtype=jnp.float32)
    v = init(jm, x, None, train=False, seed=1)
    feat_ref, heat_ref = map(np.asarray, jax.jit(lambda x_: jm.apply(v, x_, None, train=False))(x))
    port = load(HRFormer(TINY_ARCH, 5), port_weights(v, "singleformer", "singleformer."))
    port.set_routes(route != "off", True, False, fused_onepass=route == "onepass")
    with torch.no_grad():
        feat, heat = port(T(x).permute(0, 3, 1, 2))
    assert tuple(feat.shape) == (2, 16, 16, 12) and tuple(heat.shape) == (2, 5, 16, 12)
    assert np.abs(heat_ref).max() > 0.05  # O(1) maps
    assert _rel(feat.permute(0, 2, 3, 1).numpy(), feat_ref) < MODEL_REL
    assert _rel(heat.numpy(), heat_ref) < MODEL_REL


def test_hrformer_g_route_matches_jax_in_bfloat16(rng):
    """Kernel G's route in bf16 (JAX ``fused_eval_mlp``, Pallas in interpret
    mode): G's f32 result joins the residual, so from the first block on the
    stream is f32 on both sides while every projection and convolution still
    computes in bf16; the features come out f32. Held within 3e-2 of the
    largest magnitude (bf16 rounding through nine blocks and the fusions:
    one bf16 step, 2^-8, at each of a few dozen rounding points; measured
    about 0.013 for the heatmaps and 0.009 for the features, where the
    module route, whose LayerNorm output the port rounds to bf16 and JAX
    keeps in f32, is at 0.028 and 0.018)."""
    x = rng.randn(2, 64, 48, 3).astype(np.float32)
    jm = JaxHRFormer(arch=TINY_ARCH, num_joints=5, fused_eval_mlp=True, dtype=jnp.bfloat16)
    v = init(jm, x, None, train=False, seed=1)
    feat_ref, heat_ref = jax.jit(lambda x_: jm.apply(v, x_, None, train=False))(
        jnp.asarray(x, jnp.bfloat16))
    port = load(HRFormer(TINY_ARCH, 5), port_weights(v, "singleformer", "singleformer."))
    port.set_routes(True, False, True)
    with torch.no_grad():
        feat, heat = port(T(x).to(torch.bfloat16).permute(0, 3, 1, 2))
    assert feat_ref.dtype == jnp.float32 and feat.dtype == torch.float32
    feat_ref, heat_ref = np.asarray(feat_ref), np.asarray(heat_ref)
    assert np.abs(heat_ref).max() > 0.05
    assert _rel(feat.permute(0, 2, 3, 1).numpy(), feat_ref) < 3e-2
    assert _rel(heat.numpy(), heat_ref) < 3e-2


def jax_interformer(route):
    """The JAX two-stage model on the tiny HRFormer, as ``tiny_hrt_config``."""
    m = presets.tiny_hrt_config(5)["MODEL"]
    single = JaxHRFormer(arch=TINY_ARCH, num_joints=5,
                         fused_eval_block=route in FUSED_BLOCK_ROUTES,
                         fused_eval_onepass=route == "onepass", fused_eval_mlp=route == "mlp",
                         dtype=jnp.float32)
    return JaxInterFormer(
        extra=m["EXTRA"], singleformer=single, num_joints=5, d_model=m["DIM_MODEL"],
        dim_feedforward=m["DIM_FEEDFORWARD"], n_head=m["N_HEAD"],
        encoder_multi_layers=m["ENCODER_MULTI_LAYERS"], trans_size=tuple(m["TRANS_SIZE"]),
        heatmap_size=tuple(m["HEATMAP_SIZE"]), upsample_type="deconv", inter_supervision=True,
        use_pallas=route != "off", dtype=jnp.float32)


def port_interformer(variables, route):
    cfg = presets.tiny_hrt_config(5)
    cfg["DEVICE"].update(USE_KERNELS=route != "off", FUSED_BLOCK_EVAL=route in FUSED_BLOCK_ROUTES,
                         FUSED_BLOCK_EVAL_ONEPASS=route == "onepass",
                         FUSED_MLP_EVAL=route == "mlp")
    model = build_model(cfg, device="cpu")
    assert {blk.fused_onepass for blk in model.singleformer.blocks()} == {route == "onepass"}
    model.load_state_dict(params_from_jax(variables, "interformer"), strict=True)
    return model


def _person_inputs(rng, valid):
    b, n = valid.shape
    images = rng.randn(b, n, 64, 48, 3).astype(np.float32)
    return images, np.zeros((b, n, 64, 48, 1), np.float32), valid


@pytest.fixture(scope="module")
def hrt_variables():
    images, pos, valid = _person_inputs(np.random.RandomState(0), np.ones((1, 2), bool))
    return init(jax_interformer("off"), images, pos, valid, train=False, seed=4)


@pytest.mark.parametrize("route", ROUTES)
def test_interformer_matches_jax(rng, hrt_variables, route):
    """B=2, N=3 with 3 and 1 valid persons: ``multi`` and ``single``."""
    valid = np.array([[1, 1, 1], [1, 0, 0]], bool)
    args = _person_inputs(rng, valid)
    ref = jax.jit(lambda *a: jax_interformer(route).apply(hrt_variables, *a, train=False))(*args)
    model = port_interformer(hrt_variables, route)
    assert isinstance(model, InterFormer)
    reset_launches()
    with torch.no_grad():
        got = model(*map(T, args))
    assert set(launch_counts().values()) == {0}  # CPU tensors: the plain versions
    for key in ("multi", "single"):
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert g.shape == (2, 3, 5, 16, 12) and g.dtype == np.float32
        assert np.isfinite(g).all() and np.abs(r).max() > 0.05
        assert _rel(g, r) < MODEL_REL, (key, _rel(g, r))
        assert not g[~valid].any() and not r[~valid].any()


def test_build_model_dispatches_on_the_name():
    assert isinstance(build_model(presets.tiny_test_config(5), device="cpu"),
                      PureMultiInterFormer)
    model = build_model(presets.tiny_hrt_config(5), device="cpu")
    assert isinstance(model, InterFormer) and not model.training
    assert len(model.singleformer.blocks()) == 9
    for key, value in (("UPSAMPLE_TYPE", "upconv"), ("UPSAMPLE_TYPE", "multiplex"),
                       ("DOMAIN_TRANS", True), ("USE_MULTI_POS", True)):
        cfg = presets.tiny_hrt_config(5)
        cfg["MODEL"][key] = value
        assert isinstance(build_model(cfg, device="cpu").singleformer, HRFormer)
    cfg = presets.tiny_hrt_config(5)
    cfg["MODEL"]["ATTENTION_TYPE"] = "window"  # tests/test_torch_options.py holds it
    assert isinstance(build_model(cfg, device="cpu").multi_global_encoder, WindowInterEncoder)
    for key, value, err in (("ATTENTION_TYPE", "swin", ValueError),
                            ("SINGLEFORMER", "hrnet", NotImplementedError)):
        cfg = presets.tiny_hrt_config(5)
        cfg["MODEL"][key] = value
        with pytest.raises(err, match=key):
            build_model(cfg, device="cpu")
    cfg = presets.tiny_hrt_config(5)
    cfg["MODEL"]["NAME"] = "hrformer"  # the standalone HRFormer is not ported
    with pytest.raises(ValueError, match="not ported"):
        build_model(cfg, device="cpu")


@pytest.mark.parametrize("section,key,value", [("MODEL", "SINGLEFORMER_FIX", True),
                                               ("DEVICE", "FROZEN_STAGE_EVAL_MODE", True),
                                               ("DEVICE", "REMAT", "layers")])
def test_interformer_is_eval_only(section, key, value):
    """Each of these training options trains: with ``DEVICE.REMAT`` layers
    the blocks and the inter encoder are recomputed in the backward
    (``tests/test_torch_remat.py`` holds the step bit-equal). A frozen first stage
    (``SINGLEFORMER_FIX``) runs without autograd in a training forward, so
    only the rest gets gradients, and returns no ``single`` heatmaps;
    ``FROZEN_STAGE_EVAL_MODE`` alone acts on no stage (it applies to a
    frozen one). ``tests/test_torch_pretrained.py`` holds the frozen step
    against JAX."""
    cfg = presets.tiny_hrt_config(5)
    cfg[section][key] = value
    model = build_model(cfg, device="cpu")
    z = torch.zeros(1, 1, 64, 48, 3)
    args = (z, z[..., :1], torch.ones(1, 1, dtype=torch.bool))
    out = model(*args, train=True, dropout_seed=0)
    out["multi"].sum().backward()
    first = [p.grad for p in model.singleformer.parameters()]
    assert torch.isfinite(out["multi"]).all()
    if key == "SINGLEFORMER_FIX":
        assert out["single"] is None and all(g is None for g in first)
    else:
        assert out["single"] is not None and any(g is not None for g in first)
    with torch.no_grad():
        assert model(*args)["multi"].shape == (1, 1, 5, 16, 12)
