"""The HRFormer I²R-Net's training path vs the JAX package, on the CPU, f32.

* DropPath: the law of the per-sample scales, the explicit-scale override,
  and a scale of 0 leaving the block's half out.
* One ``HRFormerBlock`` training forward and backward against the JAX block
  at ``train=True`` with the BatchNorms over the valid persons, on both
  routes (modules; kernel 9, which on CPU tensors is its plain version, vs
  the JAX Pallas kernel in interpret mode), with DropPath's scales taken
  from what the JAX block drew.
* One optimizer step of the tiny two-stage model (``tiny_hrt_config``, drop
  path 0, dropout 0 on both sides) against JAX ``make_train_step`` on one
  common batch, on both routes: the losses, every gradient (mapped by
  ``convert_state_dict(..., "interformer")``), the post-step parameters and
  the BatchNorm running statistics.
* ``train_loop`` on the tiny HRT config: finite losses, checkpoints, a
  resume bit for bit, no kernel launched on CPU tensors.

Tolerances: the block, atol 1e-5 / rtol 1e-4 on its output and BN
statistics, each gradient within 1e-4 of its largest magnitude. The model
step follows ``tests/test_torch_train_step.py``: loss rtol 1e-5, BN
statistics rtol 1e-4 / atol 1e-6, gradients rtol 1e-3 / atol 1e-3 of the
tensor's largest magnitude, post-step parameters by the resolved-gradient
rule. Some leaves are 0 in exact arithmetic: the biases ahead of a
BatchNorm's mean subtraction (MlpDWBN's ``fc1``/``dw3x3``/``fc2`` and LN2's
bias, the fusion's depthwise BN bias) and ``k_proj``'s bias (softmax ignores a
bias shared by every key). Both sides hold only f32 cancellation noise there,
so those are held against their module's weight-gradient scale instead.

Post-step parameters are held tight where the gradient's sign is resolved.
In the stem (``conv1``, ``conv2``, ``layer1``: ReLUs over a 3-person batch)
JAX's own step and a separately compiled JAX gradient disagree in sign on up
to 65 elements per leaf, with gradients up to 4e-3 of the leaf's largest
value (measured; the port's gradient agrees with the latter within 2e-5
there): ReLU inputs within f32 noise of zero, as in the W48 trunk of
``tests/test_torch_train_step.py``. There, as in that test, a gradient counts
as resolved only above 10% of the leaf's largest value.

The weights' seed (22) is one where no ReLU input of the tiny batch lies
within f32 noise of zero. With seed 21 one does, in a fusion output: the
port's kernel route and its module route then differ from each other by up
to 16% of a fusion weight's gradient (JAX's two routes happen to agree
there), while with seeds 22 and 23 all four (JAX and port, both routes)
agree within 4e-4 of each leaf's largest value (measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import i2rnet_tpu.models.hrformer as hrf
import i2rnet_tpu.ops.pallas.hrformer_block_train as kmod
from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.core.train import make_train_step as j_make_train_step
from i2rnet_tpu.core.train_state import create_train_state, make_optimizer as j_make_optimizer
from i2rnet_tpu.models.interformer import InterFormer as JaxInterFormer
from i2rnet_tpu.ops.preprocess import device_preprocess as j_device_preprocess
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.core.train import make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.trainer import raw_to_device, train_loop
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models.hrformer import HRFormer, HRFormerBlock, drop_path_scale
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.layers import MaskedBatchNorm
from i2rnet_tpu_torch.ops.cuda import launch_counts, reset_launches
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from test_torch_hrformer import BLOCK, PORT_BLOCK, TINY_ARCH, init, port_weights
from test_torch_train_step import jax_dropout_zero  # noqa: F401  (fixture)

torch.set_num_threads(2)

T = torch.from_numpy
#: the tiny arch without DropPath (the model-step parity draws nothing)
ARCH0 = {k: (dict(v) if isinstance(v, dict) else 0.0) for k, v in TINY_ARCH.items()}


def test_drop_path_scale_law():
    """``floor(keep + U) / keep``: 0 or 1/keep, the dropped share near the
    rate, mean 1; rate 0 is the identity (None) after the same draw."""
    g = torch.Generator().manual_seed(0)
    s = drop_path_scale(20000, 0.2, g, "cpu")
    assert set(np.unique(s.numpy()).tolist()) == {0.0, np.float32(1 / 0.8)}
    assert abs(float((s == 0).float().mean()) - 0.2) < 0.01
    assert abs(float(s.mean()) - 1.0) < 0.02
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    assert drop_path_scale(8, 0.0, g1, "cpu") is None
    torch.rand(8, generator=g2)
    assert torch.equal(drop_path_scale(8, 0.5, g1, "cpu"), drop_path_scale(8, 0.5, g2, "cpu"))


def test_drop_path_scales_from_the_seed_or_given(rng):
    """The tiny HRFormer (drop path 0.1) in training: scales from the seed are
    reproducible and differ between seeds; explicit scales replace them; a
    sample whose scales are all 0 passes only the blocks' residuals, so its
    output equals a forward with every block's halves cut off."""
    model = HRFormer(TINY_ARCH, 5).train()
    x = T(rng.randn(3, 3, 64, 48).astype(np.float32))
    with torch.no_grad():
        a = model(x, dropout_seed=7)[1]
        b = model(x, dropout_seed=7)[1]
        c = model(x, dropout_seed=8)[1]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="dropout_seed"):
        model(x)
    n = len(model.blocks())
    ones, zeros = torch.ones(3), torch.zeros(3)
    with torch.no_grad():
        kept = model(x, drop_path_scales=[(ones, ones)] * n)[1]
        model.set_routes(False, True, False)
        for blk in model.blocks():  # the rates do not matter once scales are given
            blk.drop_path = 0.0
        plain = model(x)[1]
        cut = model(x, drop_path_scales=[(zeros, zeros)] * n)[1]
        for blk in model.blocks():
            blk.forward = lambda y: y  # noqa: B023  (blocks as the identity)
        skip = model(x)[1]
    assert torch.equal(kept, plain)
    np.testing.assert_allclose(cut.numpy(), skip.numpy(), rtol=1e-5, atol=1e-6)


def _block_grads(names, jgrads):
    """JAX block gradients under the port's parameter names."""
    sd = port_weights({"params": jgrads}, BLOCK, PORT_BLOCK)
    return {k: sd[k].numpy() for k in names}


@pytest.mark.parametrize("route", ["modules", "kernel"])
def test_block_training_matches_jax(rng, monkeypatch, route):
    """P=3 (one padded person), 10x9x16, 2 heads, DropPath 0.4 with the
    scales the JAX block drew, BN statistics over the valid persons."""
    p, h, w, c, heads = 3, 10, 9, 16, 2
    x = (rng.rand(p, h, w, c) * 2 - 1).astype(np.float32)
    cot = rng.randn(p, h, w, c).astype(np.float32)
    valid = np.array([True, True, False])
    fused = route == "kernel"
    monkeypatch.setattr(hrf, "MIN_FUSED_TRAIN_TOKENS", 1)
    jm = hrf.HRFormerBlock(channels=c, num_heads=heads, window=7, mlp_ratio=2.0,
                           drop_path=0.4, fused_train_attn=fused, dtype=jnp.float32)
    v = init(jm, x, train=False, seed=11)
    key = {"dropout": jax.random.PRNGKey(2)}

    # record what the JAX block draws: DropPath's per-sample factor, and the
    # scale handed to the Pallas kernel
    drawn, kernel_calls = [], []
    orig_dp, orig_kernel = hrf.DropPath.__call__, kmod.window_attn_block_train

    def dp_spy(self, y, deterministic=True):
        out = orig_dp(self, y, deterministic)
        factor = np.abs(np.asarray(out)).reshape(p, -1).sum(1) != 0
        drawn.append(np.where(factor, np.float32(1 / (1 - self.rate)), 0).astype(np.float32))
        return out

    def kernel_spy(*a, **k):
        kernel_calls.append(np.asarray(a[1]))
        return orig_kernel(*a, **k)

    monkeypatch.setattr(hrf.DropPath, "__call__", dp_spy)
    monkeypatch.setattr(kmod, "window_attn_block_train", kernel_spy)
    jm.apply(v, x, valid, True, mutable=["batch_stats"], rngs=key)
    monkeypatch.setattr(hrf.DropPath, "__call__", orig_dp)
    monkeypatch.setattr(kmod, "window_attn_block_train", orig_kernel)
    scales = (kernel_calls + drawn) if fused else drawn
    assert len(scales) == 2 and len(kernel_calls) == int(fused)
    assert any((sc == 0).any() for sc in scales) and any((sc != 0).any() for sc in scales)

    def loss(params, x_):
        out, mut = jm.apply({"params": params, "batch_stats": v["batch_stats"]}, x_, valid, True,
                            mutable=["batch_stats"], rngs=key)
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (ref, stats)), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))

    blk = HRFormerBlock(c, heads, 7, 2.0, drop_path=0.4)
    blk.load_state_dict(port_weights(v, BLOCK, PORT_BLOCK), strict=True)
    blk.train()
    blk.use_kernels = blk.fused_train = fused
    for bn in blk.modules():
        if isinstance(bn, MaskedBatchNorm):
            bn.person_mask = T(valid)
    blk.dp_scales = tuple(T(np.array(sc)) for sc in scales)
    xs = T(x).requires_grad_(True)
    out = blk(xs)
    (out * T(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)
    names = [n for n, _ in blk.named_parameters()]
    want = _block_grads(names, jgp)
    for n, prm in blk.named_parameters():
        got = np.zeros(prm.shape, np.float32) if prm.grad is None else prm.grad.numpy()
        # gradients 0 in exact arithmetic: held against their module's weights'
        zero = n.endswith(("k_proj.bias", "fc1.bias", "dw3x3.bias", "fc2.bias", "norm2.bias"))
        tol = 1e-4 * np.abs(want[n[:-4] + "weight" if zero else n]).max() + 1e-7
        assert np.abs(got - want[n]).max() <= tol, (n, np.abs(got - want[n]).max())
    ref_stats = port_weights({"batch_stats": stats}, BLOCK, PORT_BLOCK)
    for n, t in blk.state_dict().items():
        if "running" in n:
            np.testing.assert_allclose(t.numpy(), ref_stats[n].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=n)


def _cfg(fused: bool):
    cfg = presets.tiny_hrt_config(5)
    cfg["MODEL"]["HRFORMER_ARCH"] = ARCH0
    cfg["DEVICE"].update(USE_KERNELS=fused, FUSED_BLOCK_TRAIN=fused)
    return cfg


def _jax_model(fused: bool):
    m = presets.tiny_hrt_config(5)["MODEL"]
    single = hrf.HRFormer(arch=ARCH0, num_joints=5, fused_train_attn=fused, dtype=jnp.float32)
    return JaxInterFormer(
        extra=m["EXTRA"], singleformer=single, num_joints=5, d_model=m["DIM_MODEL"],
        dim_feedforward=m["DIM_FEEDFORWARD"], n_head=m["N_HEAD"],
        encoder_multi_layers=m["ENCODER_MULTI_LAYERS"], trans_size=tuple(m["TRANS_SIZE"]),
        heatmap_size=tuple(m["HEATMAP_SIZE"]), upsample_type="deconv", inter_supervision=True,
        use_pallas=fused, dtype=jnp.float32)


def _raw(cfg, counts=(2, 1), n_max=2, seed=5):
    return synthetic_raw_batch(cfg, list(counts), np.random.RandomState(seed), n_max=n_max,
                               raw_hw=(96, 128))


def _sd_numpy(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _tree(sd):
    variables, unmatched = convert_state_dict(sd, "interformer")
    assert not unmatched
    return variables


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


#: the stem's leaves (module docstring)
_STEM = ("['singleformer']['conv1']", "['singleformer']['conv2']", "['singleformer']['layer1_")
#: gradients that are 0 in exact arithmetic (module docstring), with the
#: leaf of the same module whose scale bounds their noise
_ZERO_GRADS = {"['k_proj']['bias']": "['k_proj']['kernel']",
               "['norm2']['bias']": "['norm2']['scale']",
               "_dwbn']['bias']": "_dwbn']['scale']",
               "['fc1']['bias']": "['fc1']['kernel']",
               "['dw3x3']['bias']": "['dw3x3']['kernel']",
               "['fc2']['bias']": "['fc2']['kernel']"}


def _grad_atol(name, ref, flat):
    for leaf, scale_leaf in _ZERO_GRADS.items():
        if name.endswith(leaf):
            return 1e-3 * np.abs(flat[name[:-len(leaf)] + scale_leaf]).max() + 1e-8
    return 1e-3 * np.abs(ref).max() + 1e-8


@pytest.mark.parametrize("fused", [True, False], ids=["kernel", "modules"])
def test_train_step_matches_jax(jax_dropout_zero, monkeypatch, fused):  # noqa: F811
    """One Adam step on one common batch (2 images x 2 slots, 3 persons)."""
    import i2rnet_tpu.ops.attention as att

    xla = att.masked_mhsa_xla  # the unfused encoder's attention-weight dropout, rate 0
    monkeypatch.setattr(att, "masked_mhsa_xla",
                        lambda q, k, v, h, mask=None, dropout_rate=0.0, dropout_rng=None:
                        xla(q, k, v, h, mask))
    monkeypatch.setattr(hrf, "MIN_FUSED_TRAIN_TOKENS", 1)
    calls = []
    orig = kmod.window_attn_block_train
    monkeypatch.setattr(kmod, "window_attn_block_train",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    cfg = _cfg(fused)
    raw = _raw(cfg)
    m = cfg["MODEL"]
    jbatch = j_device_preprocess(raw, tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]),
                                 m["SIGMA"])
    jmodel = _jax_model(fused)
    variables = init(jmodel, jbatch["images"][:1], jbatch["pos_masks"][:1],
                     np.ones((1, 2), bool), train=False, seed=22)
    from i2rnet_tpu.presets import hrt_interformer
    jcfg = hrt_interformer()
    jcfg.TRAIN.LR, jcfg.TRAIN.LR_END = cfg["TRAIN"]["LR"], cfg["TRAIN"]["LR_END"]
    jcfg.TRAIN.END_EPOCH = cfg["TRAIN"]["END_EPOCH"]
    tx, jsched = j_make_optimizer(jcfg, steps_per_epoch=1)
    jstate = create_train_state(jmodel, variables, tx)
    jstep = j_make_train_step(jmodel, tx, loss_weights=m["LOSS_WEIGHTS"], donate=False)
    new_jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(0))

    from i2rnet_tpu.core.train import compute_losses as j_compute_losses

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jbatch["images"], jbatch["pos_masks"], jbatch["person_valid"],
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return j_compute_losses(out, jbatch, m["LOSS_WEIGHTS"], True)[0]

    jgrads = jax.jit(jax.grad(j_loss))(variables["params"])
    assert bool(calls) == fused  # the JAX side ran its Pallas kernel 9 (interpret mode)

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, "interformer"), strict=True)
    model.multi_global_encoder.dropout_rate = 0.0
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), steps_per_epoch=1))
    step = make_train_step(state, m["LOSS_WEIGHTS"], cfg["LOSS"]["USE_TARGET_WEIGHT"])
    batch = {k: T(np.array(v)) for k, v in jbatch.items()}
    reset_launches()
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert set(launch_counts().values()) == {0}
    assert set(metrics) == {"loss", "acc", "loss_single", "loss_multi"}
    for k in ("loss", "loss_single", "loss_multi"):
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(metrics["acc"].item(), float(jmetrics["acc"]), atol=1e-6)

    grad_sd = _sd_numpy(model)
    for name, prm in model.named_parameters():
        grad_sd[name] = (np.zeros(prm.shape, np.float64) if prm.grad is None
                         else prm.grad.detach().double().numpy())
    g_tree = _tree(grad_sd)["params"]
    flat_ref = {jax.tree_util.keystr(p_): np.asarray(r, np.float64) for p_, r in _leaves(jgrads)}
    assert len(_leaves(g_tree)) == len(flat_ref)
    atols = {}
    for path, a in _leaves(g_tree):
        name = jax.tree_util.keystr(path)
        r = flat_ref[name]
        atols[name] = _grad_atol(name, r, flat_ref)
        np.testing.assert_allclose(a, r, rtol=1e-3, atol=atols[name], err_msg=f"grad {name}")

    lr = float(jsched(0))
    new = _tree(_sd_numpy(state.model))
    for (path, a), (_, r) in zip(_leaves(new["params"]), _leaves(new_jstate.params)):
        name = jax.tree_util.keystr(path)
        a, r, g = (np.asarray(t, np.float64) for t in (a, r, flat_ref[name]))
        noise = 0.1 * np.abs(g).max() if name.startswith(_STEM) else atols[name]
        d, resolved = np.abs(a - r), np.abs(g) > max(1e-3, noise)
        assert d[resolved].max(initial=0.0) < 3e-5 + 1e-3 * np.abs(r[resolved]).max(initial=0.0), name
        assert d.max() < 2.2 * lr, name
    for (path, a), (_, r) in zip(_leaves(new["batch_stats"]), _leaves(new_jstate.batch_stats)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=f"batch_stats {jax.tree_util.keystr(path)}")


def test_synthetic_batch_serves_the_hrt_config():
    """256x192, MAX_PATCH 2 and an empty image: the raw batch and its
    preprocessing have the recipe's shapes, padded slots invalid."""
    cfg = presets.hrt_interformer()
    raw = synthetic_raw_batch(cfg, [2, 0, 1], np.random.RandomState(0), raw_hw=(240, 320))
    assert raw["images"].shape == (3, 240, 320, 3) and raw["joints_hm"].shape == (3, 2, 17, 2)
    np.testing.assert_array_equal(raw["person_valid"], [[1, 1], [0, 0], [1, 0]])
    m = cfg["MODEL"]
    batch = device_preprocess(raw_to_device(raw, "cpu"), tuple(m["IMAGE_SIZE"]),
                              tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    assert tuple(batch["images"].shape) == (3, 2, 256, 192, 3)
    assert tuple(batch["target"].shape) == (3, 2, 17, 64, 48)
    assert not batch["target"][~batch["person_valid"]].any()


def test_train_loop_trains_the_hrt_model(tmp_path):
    """Two epochs of two steps of the tiny HRT model (DropPath 0.1, dropout
    0.1, kernel routes on: their plain versions on CPU tensors, no launch
    counted), its checkpoints, and AUTO_RESUME restoring them bit for bit."""
    cfg = presets.tiny_hrt_config(5)
    cfg["DEVICE"].update(USE_KERNELS=True, FUSED_BLOCK_TRAIN=True)
    cfg["PRINT_FREQ"] = 1
    raw = _raw(cfg, counts=(2, 0), n_max=2)
    losses = []
    reset_launches()
    state = train_loop(cfg, str(tmp_path), lambda epoch: [raw, raw], max_epochs=2, device="cpu",
                       on_step=lambda e, i, mt: losses.append(
                           (float(mt["loss"]), float(mt["loss_single"]))))
    assert set(launch_counts().values()) == {0}
    assert len(losses) == 4 and all(np.isfinite(v).all() for v in losses) and state.step == 4
    payload = load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert payload["epoch"] == 1 and payload["meta"]["model"] == "interformer"
    resumed = train_loop(cfg, str(tmp_path), lambda epoch: [raw, raw], max_epochs=2,
                         device="cpu")
    assert resumed.step == 4
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k
    a, b = resumed.optimizer.state_dict(), state.optimizer.state_dict()
    for k in b["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["state"][k][name], b["state"][k][name])
