"""The port's training modules vs their JAX counterparts on the same numpy
inputs, float32: masked BatchNorm training statistics, Gaussian targets,
``device_preprocess``, the joint losses, PCK accuracy, the cosine schedule
and the optimizers.

Tolerances: atol 1e-5 / rtol 1e-4 (f32 reductions in two orders); crops
atol 1e-4 (bilinear taps over [-2.1, 2.6], as ``test_torch_modules``);
targets, weights, losses and schedules atol 1e-6 (closed forms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from i2rnet_tpu.core.loss import joints_mse_loss as j_mse
from i2rnet_tpu.core.loss import joints_ohkm_mse_loss as j_ohkm
from i2rnet_tpu.core.train_state import cosine_epoch_schedule as j_cosine
from i2rnet_tpu.models.layers import MaskedBatchNorm as JBN
from i2rnet_tpu.ops.accuracy import pck_accuracy as j_pck
from i2rnet_tpu.ops.preprocess import device_preprocess as j_device_preprocess
from i2rnet_tpu.ops.target import generate_targets as j_targets
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.loss import joints_mse_loss, joints_ohkm_mse_loss
from i2rnet_tpu_torch.core.train_state import cosine_epoch_schedule, make_optimizer
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models.layers import MaskedBatchNorm, conv_init_
from i2rnet_tpu_torch.ops.accuracy import pck_accuracy
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.ops.target import generate_targets

torch.set_num_threads(2)

ATOL, RTOL = 1e-5, 1e-4


def _bn_pair(rng, c):
    scale, bias = rng.uniform(0.5, 1.5, c), 0.1 * rng.randn(c)
    mean, var = 0.1 * rng.randn(c), rng.uniform(0.5, 1.5, c)
    jv = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}
    jv = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jv)
    bn = MaskedBatchNorm(c)
    bn.load_state_dict({"weight": torch.tensor(scale), "bias": torch.tensor(bias),
                        "running_mean": torch.tensor(mean), "running_var": torch.tensor(var),
                        "num_batches_tracked": torch.tensor(0)})
    return jv, bn.train()


def _port_bn(bn, x, mask, g):
    """Output (NHWC), input gradient and running stats of a training forward."""
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)
    bn.person_mask = None if mask is None else torch.from_numpy(mask)
    out = bn(xt)
    (gx,) = torch.autograd.grad(out, xt, torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    return (out.detach().permute(0, 2, 3, 1).numpy(), gx.permute(0, 2, 3, 1).numpy(),
            bn.running_mean.numpy().copy(), bn.running_var.numpy().copy())


@pytest.mark.parametrize("ragged", [True, False])
def test_masked_batchnorm_training(rng, ragged):
    """Batch mean and biased variance over the valid persons only, the
    unbiased running update with momentum 0.1, and the input gradient through
    the batch statistics, against JAX ``MaskedBatchNorm(train=True)``."""
    n, h, w, c = 5, 6, 4, 8
    x = (2 * rng.randn(n, h, w, c) + 0.3).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    mask = np.array([1, 1, 0, 1, 0], bool) if ragged else None
    jv, bn = _bn_pair(rng, c)

    def jax_fn(x_):
        return JBN().apply(jv, x_, mask=mask, train=True, mutable=["batch_stats"])

    ref, upd = jax_fn(x)
    ref_gx = jax.grad(lambda x_: jnp.sum(jax_fn(x_)[0] * g))(x)
    out, gx, rmean, rvar = _port_bn(bn, x, mask, g)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gx, np.asarray(ref_gx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rmean, np.asarray(upd["batch_stats"]["mean"]), rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(rvar, np.asarray(upd["batch_stats"]["var"]), rtol=RTOL, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1


def test_masked_batchnorm_padding_invariance(rng):
    """The same 3 valid persons padded to N=4 and N=6 (padding rows random):
    the same output on the valid rows and the same running statistics."""
    c = 6
    valid = (2 * rng.randn(3, 5, 5, c) + 1.0).astype(np.float32)
    outs = []
    for n in (4, 6):
        x = np.concatenate([valid, rng.randn(n - 3, 5, 5, c).astype(np.float32) * 9], 0)
        mask = np.arange(n) < 3
        _, bn = _bn_pair(np.random.RandomState(1), c)
        outs.append(_port_bn(bn, x, mask, np.zeros_like(x)))
    np.testing.assert_allclose(outs[0][0][:3], outs[1][0][:3], rtol=1e-6, atol=1e-6)
    for a, b in zip(outs[0][2:], outs[1][2:]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_conv_init_std():
    w = torch.empty(256, 64, 3, 3)
    conv_init_(w, torch.Generator().manual_seed(0))
    assert abs(w.std().item() - 0.001) < 2e-5 and abs(w.mean().item()) < 2e-5


def test_generate_targets(rng):
    """Closed-form targets and weights with the int-truncated 3-sigma bounds
    test: joints inside, near and beyond the edges, visible or not."""
    joints = rng.uniform(-12, 30, (2, 3, 5, 2)).astype(np.float32)
    vis = (rng.rand(2, 3, 5) > 0.3).astype(np.float32)
    rt, rw = j_targets(joints, vis, (12, 16), 2)
    gt, gw = generate_targets(torch.from_numpy(joints), torch.from_numpy(vis), (12, 16), 2)
    assert gt.shape == (2, 3, 5, 16, 12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(rt), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(gw.numpy(), np.asarray(rw))
    assert 0 < gw.sum() < vis.sum()  # some visible joints fall outside


@pytest.mark.parametrize("joints_weight", [None, (1.0, 1.2, 1.5, 1.0, 1.2)])
def test_device_preprocess(joints_weight):
    """A raw training batch (rotated crops, ragged persons, a padded image)
    through both ``device_preprocess``."""
    cfg = presets.tiny_test_config(5)
    raw = synthetic_raw_batch(cfg, [3, 1, 0], np.random.RandomState(4), n_max=3,
                              raw_hw=(96, 128))
    ref = j_device_preprocess(raw, (48, 64), (12, 16), 2, joints_weight=joints_weight)
    dt = {"images": torch.uint8, "person_valid": torch.bool}
    got = device_preprocess({k: torch.as_tensor(v, dtype=dt.get(k, torch.float32))
                             for k, v in raw.items()}, (48, 64), (12, 16), 2,
                            joints_weight=joints_weight)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(ref["images"]), atol=1e-4,
                               rtol=RTOL)
    for k in ("pos_masks", "target", "target_weight"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=ATOL, rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_array_equal(got["person_valid"].numpy(), np.asarray(ref["person_valid"]))
    assert not got["target"][~got["person_valid"]].any()
    assert got["target_weight"][got["person_valid"]].any()


def _heat_batch(rng):
    b, n, k, h, w = 2, 3, 5, 16, 12
    joints = rng.uniform(0, 12, (b, n, k, 2)).astype(np.float32)
    target, tw = j_targets(joints, np.ones((b, n, k), np.float32), (w, h), 2)
    pred = (np.asarray(target) + 0.3 * rng.randn(b, n, k, h, w)).astype(np.float32)
    valid = np.array([[1, 1, 1], [1, 0, 0]], bool)
    tw = np.asarray(tw) * (rng.rand(b, n, k) > 0.2)
    return pred, np.array(target), tw.astype(np.float32), valid


@pytest.mark.parametrize("use_weight", [True, False])
def test_joint_losses(rng, use_weight):
    """MSE and OHKM under a ragged person mask, with and without target
    weights, and without a mask."""
    pred, target, tw, valid = _heat_batch(rng)
    tw = tw if use_weight else None

    def t(a):
        return None if a is None else torch.from_numpy(a)

    for mask in (valid, None):
        np.testing.assert_allclose(
            joints_mse_loss(t(pred), t(target), t(tw), t(mask)).item(),
            float(j_mse(pred, target, tw, mask)), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(
            joints_ohkm_mse_loss(t(pred), t(target), t(tw), t(mask), topk=3).item(),
            float(j_ohkm(pred, target, tw, mask, topk=3)), rtol=1e-6, atol=1e-7)


def test_pck_accuracy(rng):
    pred, target, _, valid = _heat_batch(rng)
    for mask in (valid, None):
        ra, rj, rn = j_pck(pred, target, mask)
        ga, gj, gn = pck_accuracy(torch.from_numpy(pred), torch.from_numpy(target),
                                  None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(ga.item(), float(ra), rtol=1e-6)
        np.testing.assert_allclose(gj.numpy(), np.asarray(rj), rtol=1e-6)
        assert int(gn) == int(rn)


@pytest.mark.parametrize("steps_per_epoch", [1, 3])
def test_cosine_schedule(steps_per_epoch):
    ref = j_cosine(5e-4, 5e-5, 6, steps_per_epoch)
    got = cosine_epoch_schedule(5e-4, 5e-5, 6, steps_per_epoch)
    for step in range(0, 25):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizers_match_optax(rng, opt):
    """Three steps of the port's optimizer with the schedule set per step vs
    the JAX package's optax chain: Adam without weight decay, SGD with
    momentum, weight decay and nesterov."""
    cfg = presets.tiny_test_config(5)
    cfg["TRAIN"].update(OPTIMIZER=opt, LR=0.01, LR_END=0.001, END_EPOCH=3, NESTEROV=True,
                        WD=0.05)
    t = cfg["TRAIN"]
    grads = [rng.randn(7).astype(np.float32) for _ in range(3)]
    p0 = rng.randn(7).astype(np.float32)
    sched = j_cosine(t["LR"], t["LR_END"], t["END_EPOCH"], 1)
    tx = (optax.adam(sched) if opt == "adam" else
          optax.chain(optax.add_decayed_weights(t["WD"]),
                      optax.sgd(sched, momentum=t["MOMENTUM"], nesterov=True)))
    jp, st = jnp.asarray(p0), None
    st = tx.init(jp)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    optimizer, schedule = make_optimizer(cfg, [param], steps_per_epoch=1)
    for i, g in enumerate(grads):
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        for group in optimizer.param_groups:
            group["lr"] = schedule(i)
        param.grad = torch.from_numpy(g.copy())
        optimizer.step()
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
