"""The model options no recipe uses, ported, vs the JAX package on the CPU.

Each option builds through the port's ``build_model`` from the JAX config
(``presets.from_config``), takes the JAX weights through ``params_from_jax``
and runs on the same seeded numpy inputs as the JAX model: the box-mask
position modes ``sine`` and ``cat_vec`` (the latter also at C + vec = 136 >
128 channels, one head, so the encoder and its kernels' plain versions run
past the old width), ``ATTENTION_TYPE: window``, TransPose-H's
``PE_ONLY_AT_BEGIN`` and ``POS_EMBEDDING: none``, deconv kernel sizes 2 and
3 (multiplex and deconv upsampling), HRFormer's ``use_rpe`` (the block in
the window-token and the 4D einsum forms, and the whole first stage), and
the encoder's pre-norm (``normalize_before``). Each in eval and in a training
forward (the JAX dropout sites at rate 0, as ``test_torch_train_step``; the
port's encoders at rate 0), the JAX Pallas kernels in interpret mode, the
port's kernel routes on (their plain versions on CPU tensors, no launch).

Tolerance: atol 1e-5 / rtol 1e-4 in f32 (``tests/test_torch_transpose_h.py``);
the HRFormer first stage within 1e-4 of the largest magnitude, as
``tests/test_torch_hrformer.py``; a whole model's training forward rtol 1e-4
with atol 1e-4 of the largest magnitude, since its BatchNorms normalise by
the statistics of the batch's four valid persons, which carry the two
frameworks' f32 orders into every element (measured: 3e-5 at most, on
elements below 1e-2 of the largest). The converter round trips are bit for
bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.models.encoder import TransformerEncoder as JaxEncoder
from i2rnet_tpu.models.hrformer import HRFormer as JaxHRFormer
from i2rnet_tpu.models.hrformer import HRFormerBlock as JaxBlock
from i2rnet_tpu.models.interformer import InterFormer as JaxInterFormer
from i2rnet_tpu.models.position import PositionEmbeddingImage as JaxPosition
from i2rnet_tpu.models.position import sine_position_embedding_multi as jax_sine_multi
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.models.encoder import TransformerEncoder, WindowInterEncoder
from i2rnet_tpu_torch.models.hrformer import HRFormer, HRFormerBlock
from i2rnet_tpu_torch.models.interformer import InterFormer, build_model
from i2rnet_tpu_torch.models.layers import DECONV_PADDING
from i2rnet_tpu_torch.models.position import (PositionEmbeddingImage,
                                              sine_position_embedding_multi)
from i2rnet_tpu_torch.ops.cuda import KERNELS, launch_counts, reset_launches
from test_torch_hrformer import BLOCK, PORT_BLOCK, TINY_ARCH, init, load, port_weights
from test_torch_train_step import jax_dropout_zero  # noqa: F401 (a fixture)
from test_torch_transpose_h import RAGGED, inputs, jax_cfg, jax_model, port
from test_torch_bridge import random_variables

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4
MODEL_REL = 1e-4
T = torch.from_numpy

#: (id, MODEL overrides, EXTRA overrides) of the TPH two-stage tiny model
OPTIONS = [
    ("sine", dict(MULTI_POS_EMBEDDING="sine"), {}),
    ("cat_vec", dict(MULTI_POS_EMBEDDING="cat_vec", MULTI_POS_EMBEDDING_DIM=8), {}),
    # C + vec = 16 + 120 = 136 > 128, one head: the widths the widened kernels take
    ("cat_vec_136", dict(MULTI_POS_EMBEDDING="cat_vec", MULTI_POS_EMBEDDING_DIM=120,
                         N_HEAD=1), {}),
    ("window", dict(ATTENTION_TYPE="window", WINDOW_SIZE=4), {}),
    ("window_cat_vec", dict(ATTENTION_TYPE="window", MULTI_POS_EMBEDDING="cat_vec",
                            MULTI_POS_EMBEDDING_DIM=8), {}),
    ("pe_only_at_begin", dict(PE_ONLY_AT_BEGIN=True, ENCODER_LAYERS=2), {}),
    ("pos_none", dict(POS_EMBEDDING="none"), {}),
    ("deconv2_multiplex", {}, dict(NUM_DECONV_KERNELS=[2])),
    ("deconv3_deconv", dict(UPSAMPLE_TYPE="deconv"), dict(NUM_DECONV_KERNELS=[3])),
]
IDS = [o[0] for o in OPTIONS]


def option_cfg(model, extra):
    cfg = jax_cfg(**model)
    for k, v in extra.items():
        setattr(cfg.MODEL.EXTRA, k, v)
    return cfg


def _check(got, ref, valid, atol_rel=None):
    """``atol_rel``: atol as that share of the largest magnitude (else ATOL)."""
    for key in ("multi", "single"):
        g, r = got[key].detach().numpy(), np.asarray(ref[key])
        assert g.shape == (2, 3, 5, 16, 12) and g.dtype == np.float32
        assert np.isfinite(g).all() and np.abs(r).max() > 0.05
        atol = ATOL if atol_rel is None else atol_rel * np.abs(r).max()
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=atol, err_msg=key)
        assert not g[~valid].any() and not r[~valid].any()


@pytest.mark.parametrize("option", OPTIONS, ids=IDS)
def test_option_matches_jax_in_eval(rng, option):
    """B=2, N=3 with 3 and 1 valid persons: ``multi`` and ``single``."""
    _, model_kw, extra = option
    cfg = option_cfg(model_kw, extra)
    jm = jax_model(cfg)
    variables = random_variables(jm, cfg, seed=2)
    args = inputs(rng, RAGGED)
    ref = jax.jit(lambda *a: jm.apply(variables, *a, train=False))(*args)
    model = port(cfg, variables)
    assert isinstance(model, InterFormer)
    reset_launches()
    with torch.no_grad():
        got = model(*map(T, args))
    assert launch_counts() == dict.fromkeys(KERNELS, 0)  # CPU tensors: the plain versions
    _check(got, ref, RAGGED)


@pytest.mark.parametrize("option", OPTIONS, ids=IDS)
def test_option_matches_jax_in_training(rng, option, jax_dropout_zero):  # noqa: F811
    """The training forward (BatchNorm over the valid persons, dropout 0)."""
    _, model_kw, extra = option
    cfg = option_cfg(model_kw, extra)
    jm = jax_model(cfg)
    variables = random_variables(jm, cfg, seed=3)
    args = inputs(rng, RAGGED)
    ref, _ = jax.jit(lambda *a: jm.apply(variables, *a, train=True, mutable=["batch_stats"],
                                         rngs={"dropout": jax.random.PRNGKey(0)}))(*args)
    model = port(cfg, variables)
    for encoder in model.encoders():
        encoder.dropout_rate = 0.0
    got = model(*map(T, args), train=True, dropout_seed=0)
    _check(got, ref, RAGGED, atol_rel=MODEL_REL)


def test_the_options_build_what_they_name():
    """Widths, modules and names of each option's port model."""
    models = {i: port(option_cfg(m, e), random_variables(jax_model(option_cfg(m, e)),
                                                          option_cfg(m, e), seed=1))
              for i, m, e in OPTIONS}
    wide = models["cat_vec_136"]
    assert wide.multi_global_encoder.layers[0].norm1.normalized_shape == (136,)
    assert tuple(wide.fc.weight.shape) == (16, 136, 1, 1)
    assert tuple(wide.multi_position_embedding.fc.weight.shape) == (120, 4 * 3)
    assert not hasattr(models["sine"], "fc") and not models["sine"].cat_vec
    window = models["window"].multi_global_encoder
    assert isinstance(window, WindowInterEncoder) and list(window.offsets()) == []
    assert tuple(window.attn["attn"].relative_position_bias_table.shape) == (49, 2)
    assert models["pe_only_at_begin"].singleformer.global_encoder.pe_only_at_begin
    assert models["pos_none"].singleformer.pos_embedding is None
    for name, k in (("deconv2_multiplex", 2), ("deconv3_deconv", 3)):
        deconv = next(m for m in models[name].modules() if isinstance(m, torch.nn.ConvTranspose2d))
        assert deconv.kernel_size == (k, k)
        assert (deconv.padding[0], deconv.output_padding[0]) == DECONV_PADDING[k]


#: the options whose every name the JAX converter maps (its window, cat_vec
#: and deconv rules, ``torch_import.py:145-153, 235-253``)
ROUND_TRIPS = [o for o in OPTIONS if o[0] in ("cat_vec", "window", "window_cat_vec",
                                               "deconv2_multiplex", "deconv3_deconv", "sine")]


@pytest.mark.parametrize("option", ROUND_TRIPS, ids=[o[0] for o in ROUND_TRIPS])
def test_round_trip_is_exact(option):
    """``params_from_jax`` then the JAX package's ``convert_state_dict``: bit
    for bit, every name matched, the state dict exactly the port model's."""
    _, model_kw, extra = option
    cfg = option_cfg(model_kw, extra)
    variables = random_variables(jax_model(cfg), cfg, seed=5)
    sd = {k: v.numpy() for k, v in params_from_jax(variables, cfg.MODEL.NAME).items()}
    back, unmatched = convert_state_dict(sd, cfg.MODEL.NAME, strict=True)
    assert unmatched == []
    flat_in = jax.tree_util.tree_leaves_with_path(variables)
    flat_out = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_in] == [p for p, _ in flat_out]
    for (path, a), (_, b) in zip(flat_in, flat_out):
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=jax.tree_util.keystr(path))
    own = build_model(presets.from_config(cfg), device="cpu").state_dict()
    assert set(sd) == set(own)
    assert {k: v.shape for k, v in sd.items()} == {k: tuple(v.shape) for k, v in own.items()}


@pytest.mark.parametrize("mode", ["sine", "cat_vec"])
def test_position_mode_matches_jax(rng, mode):
    """The embedding alone: ``sine`` the multi-person table (equal to JAX's),
    broadcast over B; ``cat_vec`` the pooled mask through ``fc``."""
    pos = inputs(rng, RAGGED)[1]
    jm = JaxPosition((4, 3), 16, mode=mode, vec_dim=8, dtype=jnp.float32)
    v = init(jm, pos, None, train=False, seed=6)
    ref = np.asarray(jm.apply(v, pos, None, train=False))
    pm = PositionEmbeddingImage((4, 3), 16, mode, 8)
    if mode == "cat_vec":
        w = v["params"]["fc"]
        pm.fc.load_state_dict({"weight": T(np.asarray(w["kernel"]).T.copy()),
                               "bias": T(np.asarray(w["bias"]))})
    np.testing.assert_array_equal(sine_position_embedding_multi(3, 4, 3, 16),
                                  jax_sine_multi(3, 4, 3, 16))
    with torch.no_grad():
        got = pm(T(pos)).numpy()
    assert got.shape == ref.shape == (2, 3, 4, 3, 8 if mode == "cat_vec" else 16)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def jax_hrt(single, **kw):
    m = presets.tiny_hrt_config(5)["MODEL"]
    return JaxInterFormer(
        extra=m["EXTRA"], singleformer=single, num_joints=5, d_model=m["DIM_MODEL"],
        dim_feedforward=m["DIM_FEEDFORWARD"], n_head=m["N_HEAD"],
        encoder_multi_layers=m["ENCODER_MULTI_LAYERS"], trans_size=tuple(m["TRANS_SIZE"]),
        heatmap_size=tuple(m["HEATMAP_SIZE"]), upsample_type="deconv", inter_supervision=True,
        use_pallas=True, dtype=jnp.float32, **kw)


def test_hrt_cat_vec_matches_jax(rng):
    """The HRFormer two-stage model with ``cat_vec`` (the HRT recipes' route:
    16 + 8 channels in the inter encoder here), kernel routes on."""
    valid = RAGGED
    images, pos, _ = inputs(rng, valid)
    single = JaxHRFormer(arch=TINY_ARCH, num_joints=5, fused_eval_block=True, dtype=jnp.float32)
    jm = jax_hrt(single, use_multi_pos=True, multi_pos_mode="cat_vec", multi_pos_dim=8)
    variables = init(jm, images, pos, valid, train=False, seed=7)
    ref = jax.jit(lambda *a: jm.apply(variables, *a, train=False))(images, pos, valid)
    cfg = presets.tiny_hrt_config(5)
    cfg["MODEL"].update(USE_MULTI_POS=True, MULTI_POS_EMBEDDING="cat_vec",
                        MULTI_POS_EMBEDDING_DIM=8)
    model = build_model(cfg, use_kernels=True, device="cpu")
    model.load_state_dict(params_from_jax(variables, "interformer"), strict=True)
    with torch.no_grad():
        got = model(*map(T, (images, pos, valid)))
    for key in ("multi", "single"):
        g, r = got[key].numpy(), np.asarray(ref[key])
        assert np.abs(r).max() > 0.05
        assert np.abs(g - r).max() / np.abs(r).max() < MODEL_REL, key


@pytest.mark.parametrize("einsum", [False, True], ids=["window_tokens", "einsum_4d"])
def test_use_rpe_block_matches_jax(rng, einsum, jax_dropout_zero):  # noqa: F811
    """``use_rpe`` on one block, eval and training (BatchNorm batch
    statistics), against JAX's window-token and 4D einsum forms; the port's
    kernel routes on take the modules by rule."""
    x = (rng.rand(2, 18, 13, 16) * 2 - 1).astype(np.float32)
    jm = JaxBlock(channels=16, num_heads=2, window=7, mlp_ratio=2.0, use_rpe=True,
                  fused_eval_block=True, fused_train_attn=True, einsum_attn=einsum,
                  dtype=jnp.float32)
    v = init(jm, x, train=False, seed=8)
    blk = load(HRFormerBlock(16, 2, 7, 2.0, use_rpe=True), port_weights(v, BLOCK, PORT_BLOCK))
    blk.use_kernels = blk.fused_block = blk.fused_train = True
    ref = np.asarray(jax.jit(lambda a: jm.apply(v, a, train=False))(x))
    with torch.no_grad():
        got = blk(T(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    ref, _ = jax.jit(lambda a: jm.apply(v, a, train=True, mutable=["batch_stats"],
                                        rngs={"dropout": jax.random.PRNGKey(0)}))(x)
    got = blk.train()(T(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_use_rpe_hrformer_matches_jax(rng):
    """The tiny HRFormer first stage with ``use_rpe``, every route on: the
    bias in every block, features and heatmaps as JAX's."""
    x = rng.randn(2, 64, 48, 3).astype(np.float32)
    jm = JaxHRFormer(arch=TINY_ARCH, num_joints=5, use_rpe=True, fused_eval_block=True,
                     dtype=jnp.float32)
    v = init(jm, x, None, train=False, seed=9)
    feat_ref, heat_ref = map(np.asarray, jax.jit(lambda a: jm.apply(v, a, None, train=False))(x))
    model = load(HRFormer(TINY_ARCH, 5, use_rpe=True),
                 port_weights(v, "singleformer", "singleformer."))
    assert all(blk.use_rpe for blk in model.blocks())
    model.set_routes(True, True, False)
    with torch.no_grad():
        feat, heat = model(T(x).permute(0, 3, 1, 2))
    rel = lambda g, r: np.abs(g - r).max() / np.abs(r).max()  # noqa: E731
    assert rel(feat.permute(0, 2, 3, 1).numpy(), feat_ref) < MODEL_REL
    assert rel(heat.numpy(), heat_ref) < MODEL_REL
    plain = load(HRFormer(TINY_ARCH, 5), port_weights(v, "singleformer", "singleformer."))
    with torch.no_grad():
        assert rel(plain(T(x).permute(0, 3, 1, 2))[1].numpy(), heat_ref) > 1e-3


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain", "kernels"])
def test_pre_norm_encoder_matches_jax(rng, use_kernels, jax_dropout_zero):  # noqa: F811
    """``normalize_before`` over [2, 24, 16] tokens with a key mask and a
    position term, two layers, eval (JAX's Pallas attention) and training."""
    src = rng.randn(2, 24, 16).astype(np.float32)
    pos = rng.randn(2, 24, 16).astype(np.float32)
    mask = np.zeros((2, 24), bool)
    mask[1, 12:] = True
    jm = JaxEncoder(num_layers=2, num_heads=2, dim_feedforward=32, normalize_before=True,
                    use_pallas=True, dtype=jnp.float32)
    v = init(jm, src, mask, pos, seed=10)
    enc = TransformerEncoder(2, 16, 2, 32, use_kernels=use_kernels, normalize_before=True)
    sd = port_weights(v, "multi_encoder", "multi_global_encoder.")
    enc.load_state_dict(sd, strict=True)
    ref = np.asarray(jax.jit(lambda *a: jm.apply(v, *a, deterministic=True))(src, mask, pos))
    with torch.no_grad():
        got = enc.eval()(T(src), T(mask), T(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    ref = jax.jit(lambda *a: jm.apply(v, *a, deterministic=False,
                                      rngs={"dropout": jax.random.PRNGKey(0)}))(src, mask, pos)
    enc.train().dropout_rate = 0.0
    got = enc(T(src), T(mask), T(pos))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    post = TransformerEncoder(2, 16, 2, 32)
    post.load_state_dict(sd, strict=True)
    with torch.no_grad():
        assert not np.allclose(post.eval()(T(src), T(mask), T(pos)).numpy(), got.detach().numpy())
