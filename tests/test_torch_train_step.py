"""One training step of the whole model vs the JAX package, and the trainer.

The parity case mirrors ``tests/test_train_parity.py`` with the JAX package
as the reference: ``tiny_test_config(5)``, float32, dropout 0 on both sides
(the JAX layers' dropout sites patched to rate 0, its Pallas training kernels
still run, in interpret mode), Adam with the per-epoch cosine LR, the same
weights (``params_from_jax``) and the same raw batch through both
``device_preprocess``. Compared: the loss on each side's own batch, then on
one common batch every gradient (the port's mapped to the JAX tree by
``convert_state_dict``), the post-step parameters (the resolved-gradient rule
of ``test_train_parity.py:219-240``), the BatchNorm running statistics and
the LR at steps 0 and 1.

Tolerances: loss rtol 1e-5; BN statistics rtol 1e-4 / atol 1e-6;
gradients rtol 1e-3 / atol 1e-3 of the tensor's largest value (f32
summation orders through two frameworks' convolutions), except in the HRNet
trunk: atol 10% of the largest value and the relative L2 error under 5%.
There a ReLU input within ~1e-7 of zero takes either branch in float32, and
through the statistics of a tiny batch one such element moves a whole
channel's gradient by a few percent of its largest value, on either side
(measured on five seeds: up to 7.8% of the largest value, 2.2% in L2; the
port's own float32 gradient strays from its float64 one as far). The
gradients are taken on one common batch, since crops that agree to 1e-4 flip
many more such elements.
"""

import jax
import numpy as np
import pytest
import torch

from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.core.train import make_train_step as j_make_train_step
from i2rnet_tpu.core.train_state import create_train_state, make_optimizer as j_make_optimizer
from i2rnet_tpu.ops.preprocess import device_preprocess as j_device_preprocess
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.train import compute_losses, make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.trainer import raw_to_device, train_loop
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from test_torch_bridge import port_model, random_variables, tiny_jax_model

torch.set_num_threads(2)


@pytest.fixture
def jax_dropout_zero(monkeypatch):
    """Rate 0 at every JAX dropout site of the encoder: flax ``nn.Dropout``
    (attention output, as ``test_train_parity.no_flax_dropout``) and the two
    training kernels, which still run, in interpret mode."""
    from flax import linen as fnn

    import i2rnet_tpu.ops.attention as att
    import i2rnet_tpu.ops.pallas.encoder_ffn_train as ffn
    from i2rnet_tpu.ops.pallas.mhsa_train import masked_mhsa_train

    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=True, rng=None: x)
    monkeypatch.setattr(att, "masked_mhsa_flash_train",
                        lambda q, k, v, h, mask=None, dropout_rate=0.0, dropout_rng=None:
                        masked_mhsa_train(q, k, v, h, key_padding_mask=mask, interpret=True))
    monkeypatch.setattr(ffn, "encoder_ffn_train_auto",
                        lambda x, *p, dropout_rate=0.0, dropout_rng=None, eps=1e-5:
                        ffn.encoder_ffn_train(x, *p[:8], 0.0, eps=eps, interpret=True))


def _raw(cfg, counts=(3, 2), n_max=3, seed=5):
    return synthetic_raw_batch(cfg, list(counts), np.random.RandomState(seed), n_max=n_max,
                               raw_hw=(96, 128))


def _sd_numpy(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _tree(sd):
    variables, unmatched = convert_state_dict(sd, "interformer_pureMulti")
    assert not unmatched
    return variables


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


def _port_grads(model):
    grad_sd = _sd_numpy(model)
    for name, p in model.named_parameters():
        # unused branches have no torch gradient: zero, as JAX's
        grad_sd[name] = (np.zeros(p.shape, np.float64) if p.grad is None
                         else p.grad.detach().double().numpy())
    return _tree(grad_sd)["params"]


def _grad_noise(name, ref):
    """The atol of a gradient tensor (module docstring)."""
    return (0.1 if name.startswith("['trunk']") else 1e-3) * np.abs(ref).max() + 1e-8


def assert_grads_close(g_tree, jgrads):
    assert len(_leaves(g_tree)) == len(_leaves(jgrads))
    for (path, a), (_, r) in zip(_leaves(g_tree), _leaves(jgrads)):
        name, r = jax.tree_util.keystr(path), np.asarray(r, np.float64)
        np.testing.assert_allclose(a, r, rtol=1e-3, atol=_grad_noise(name, r),
                                   err_msg=f"grad {name}")
        if name.startswith("['trunk']"):
            assert np.linalg.norm(a - r) <= 0.05 * np.linalg.norm(r), name


def test_train_step_matches_jax(jax_dropout_zero):
    jcfg, jmodel = tiny_jax_model(use_pallas=True)
    variables = random_variables(jmodel, jcfg, seed=3)
    check_train_step(jcfg, jmodel, variables, _raw(presets.from_config(jcfg)))


def check_train_step(jcfg, jmodel, variables, raw):
    """One Adam step of the port against JAX ``make_train_step`` on ``raw``
    (the module docstring's comparisons and tolerances); the caller patches
    the JAX dropout sites to rate 0 (``jax_dropout_zero``)."""
    cfg = presets.from_config(jcfg)
    m = cfg["MODEL"]
    prep = (tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]), m["SIGMA"])

    # JAX: make_train_step with Adam, and its gradients
    jbatch = j_device_preprocess(raw, *prep)
    tx, jsched = j_make_optimizer(jcfg, steps_per_epoch=1)
    jstate = create_train_state(jmodel, variables, tx)
    jstep = j_make_train_step(jmodel, tx, loss_weights=jcfg.MODEL.LOSS_WEIGHTS,
                              use_target_weight=jcfg.LOSS.USE_TARGET_WEIGHT, donate=False)
    new_jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(0))

    from i2rnet_tpu.core.train import compute_losses as j_compute_losses

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jbatch["images"], jbatch["pos_masks"], jbatch["person_valid"],
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return j_compute_losses(out, jbatch, jcfg.MODEL.LOSS_WEIGHTS, True)[0]

    jgrads = jax.jit(jax.grad(j_loss))(variables["params"])

    def port_state():
        model = port_model(variables, jcfg)
        model.global_encoder.dropout_rate = 0.0
        state = TrainState(model, *make_optimizer(cfg, model.parameters(), steps_per_epoch=1))
        return state, make_train_step(state, m["LOSS_WEIGHTS"], cfg["LOSS"]["USE_TARGET_WEIGHT"])

    # the port's step on its own preprocessing of the raw batch
    state, step = port_state()
    metrics = step(device_preprocess(raw_to_device(raw, "cpu"), *prep),
                   torch.Generator().manual_seed(0))
    assert set(metrics) == {"loss", "acc", "loss_multi"} and state.step == 1
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["acc"].item(), float(jmetrics["acc"]), atol=1e-6)
    for s in (0, 1):
        np.testing.assert_allclose(state.schedule(s), float(jsched(s)), rtol=1e-6)

    # gradients, post-step parameters and BN statistics on the JAX batch
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    state, step = port_state()
    metrics = step(batch, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(metrics["loss"].item(), float(jmetrics["loss"]), rtol=1e-5)
    assert_grads_close(_port_grads(state.model), jgrads)

    # post-step parameters: tight where the gradient is resolved (above 1e-3
    # and its tolerance), else the 2*lr bound of Adam's first step (the sign
    # of a noise-level gradient)
    lr = float(jsched(0))
    new = _tree(_sd_numpy(state.model))
    for (path, a), (_, r), (_, g) in zip(_leaves(new["params"]), _leaves(new_jstate.params),
                                         _leaves(jgrads)):
        a, r, g = (np.asarray(x, np.float64) for x in (a, r, g))
        name = jax.tree_util.keystr(path)
        d, resolved = np.abs(a - r), np.abs(g) > max(1e-3, _grad_noise(name, g))
        assert d[resolved].max(initial=0.0) < 3e-5 + 1e-3 * np.abs(r[resolved]).max(initial=0.0), name
        assert d.max() < 2.2 * lr, name
    for (path, a), (_, r) in zip(_leaves(new["batch_stats"]), _leaves(new_jstate.batch_stats)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=f"batch_stats {jax.tree_util.keystr(path)}")


def test_train_loss_is_padding_invariant():
    """The same 5 persons at N=3 and N=4 slots give the same training loss
    and the same BatchNorm running statistics (``test_train_parity.py:
    278-331`` pins this for JAX)."""
    jcfg, jmodel = tiny_jax_model(use_pallas=False)
    variables = random_variables(jmodel, jcfg, seed=4)
    cfg = presets.from_config(jcfg)
    # the same draws: n_max only adds padded slots (identity affines, far boxes)
    raw3, raw4 = _raw(cfg, counts=(3, 2), n_max=3), _raw(cfg, counts=(3, 2), n_max=4)
    m = cfg["MODEL"]
    out = []
    for raw in (raw3, raw4):
        model = port_model(variables, jcfg)
        model.global_encoder.dropout_rate = 0.0
        batch = device_preprocess(raw_to_device(raw, "cpu"), tuple(m["IMAGE_SIZE"]),
                                  tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
        with torch.no_grad():
            heat = model(batch["images"], batch["pos_masks"], batch["person_valid"], train=True)
        loss, _ = compute_losses({"multi": heat}, batch, m["LOSS_WEIGHTS"], True)
        stats = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        out.append((loss.item(), stats))
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-6)
    for k, v in out[0][1].items():
        np.testing.assert_allclose(v.numpy(), out[1][1][k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def _tiny_cfg(**top):
    cfg = presets.tiny_test_config(5)
    cfg.update(top)
    return cfg


def test_train_loop_checkpoints_and_resumes(tmp_path):
    """Two epochs of two steps with dropout on write their checkpoints and the
    final state; AUTO_RESUME then restores the newest one (weights, optimizer
    state, step) and trains the next epoch only."""
    cfg = _tiny_cfg(PRINT_FREQ=1)
    raw = _raw(cfg)
    losses = []
    state = train_loop(cfg, str(tmp_path), lambda epoch: [raw, raw], max_epochs=2, device="cpu",
                       on_step=lambda e, i, mt: losses.append((e, i, float(mt["loss"]))))
    assert [(e, i) for e, i, _ in losses] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert all(np.isfinite(v) for *_, v in losses) and state.step == 4
    assert sorted(p.name for p in (tmp_path / "checkpoint").iterdir()) == ["epoch_0.pth",
                                                                          "epoch_1.pth"]
    assert (tmp_path / "final_state.pth").exists()
    ckpt = latest_checkpoint(str(tmp_path))
    payload = load_checkpoint(ckpt)
    assert ckpt.endswith("epoch_1.pth") and payload["epoch"] == 1 and payload["step"] == 4
    assert payload["meta"] == {"model": "interformer_pureMulti", "train_global_steps": 4,
                               "valid_global_steps": 0}

    resumed = train_loop(cfg, str(tmp_path), lambda epoch: [raw, raw], max_epochs=2,
                         device="cpu")  # the next epoch is 2 = the end: nothing to run
    assert resumed.step == 4
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k
    a, b = resumed.optimizer.state_dict(), state.optimizer.state_dict()
    for k in b["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["state"][k][name], b["state"][k][name])

    seen = []
    train_loop(cfg, str(tmp_path), lambda epoch: [raw, raw], max_epochs=3, device="cpu",
               on_step=lambda e, i, mt: seen.append((e, i)))
    assert seen == [(2, 0), (2, 1)]
    assert load_checkpoint(latest_checkpoint(str(tmp_path)))["step"] == 6


def test_train_loop_halts_on_a_non_finite_loss(tmp_path):
    """A NaN loss raises FloatingPointError, at a print step or when the
    epoch's deferred metrics are read, before its checkpoint is written."""
    cfg = _tiny_cfg()  # PRINT_FREQ 100: step 1's loss is read after the loop
    raw = _raw(cfg)
    bad = dict(raw, joints_hm=np.full_like(raw["joints_hm"], np.nan))
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        train_loop(cfg, str(tmp_path), lambda epoch: [raw, bad], max_epochs=1, device="cpu")
    assert latest_checkpoint(str(tmp_path)) is None
