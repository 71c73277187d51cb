"""``DEVICE.REMAT``: activations recomputed in the backward, the same step.

Port of what ``tests/test_remat.py`` holds for the JAX package. A training
step of the port under ``layers``, ``dots`` or ``full`` is the step with
REMAT off, bit for bit in float32 on the CPU: the loss, every gradient, the
post-Adam parameters and the BatchNorm running statistics (each statistic
moves once a step, though the recomputation runs its BatchNorm again). No
case needs a tolerance: the recomputation runs the same ops on the same
inputs in the same order, and ``dots`` hands back the products it kept.
Each of the three tiny models runs on both training routes: the modules and
the kernels' plain versions (Kernels C and D in the encoders; the HRFormer
on kernel 9's route too), which a CUDA tensor would launch.

Also: the port's ``full`` step against the JAX ``make_train_step(remat=
"full")`` on the same weights (``test_torch_train_step.py``'s tolerances);
an unknown value refused before anything is built; the recomputed regions
run each kernel's forward again; and the bytes autograd keeps for the
backward fall under each mode.
"""

import numpy as np
import pytest
import torch

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.train import REMAT_VALUES, make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.trainer import raw_to_device, train_loop
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models import encoder, hrformer, layers
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from test_torch_bridge import random_variables, tiny_jax_model
from test_torch_train_step import _raw, check_train_step, jax_dropout_zero  # noqa: F401

torch.set_num_threads(2)

MODELS = {"w48": presets.tiny_test_config, "hrt": presets.tiny_hrt_config,
          "tph": presets.tiny_tph_config}
MODES = ("layers", "dots", "full")


def _cfg(name, remat, kernels):
    cfg = MODELS[name]()
    cfg["DEVICE"].update(REMAT=remat, USE_KERNELS=kernels, FUSED_BLOCK_TRAIN=kernels)
    return cfg


def _batch(cfg):
    m = cfg["MODEL"]
    raw = synthetic_raw_batch(cfg, [3, 2], np.random.RandomState(5), n_max=3, raw_hw=(96, 128))
    return device_preprocess(raw_to_device(raw, "cpu"), tuple(m["IMAGE_SIZE"]),
                             tuple(m["HEATMAP_SIZE"]), m["SIGMA"])


def _step(name, remat, kernels):
    """One Adam step of the tiny model ``name`` from the seeded JAX
    initialisation: (metrics, gradients, post-step state dict)."""
    cfg = _cfg(name, remat, kernels)
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), 10))
    step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"], remat=remat)
    metrics = step(_batch(cfg), torch.Generator().manual_seed(0))
    grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    return metrics, grads, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kernels", [False, True], ids=["modules", "kernel_routes"])
@pytest.mark.parametrize("name", list(MODELS))
def test_remat_step_equals_default(name, kernels):
    m0, g0, s0 = _step(name, "none", kernels)
    assert s0["final_layer.weight"].ne(0).any()
    for mode in MODES:
        m1, g1, s1 = _step(name, mode, kernels)
        assert set(m1) == set(m0)
        for k in m0:
            assert torch.equal(m1[k], m0[k]), (mode, k)
        assert g1.keys() == g0.keys(), mode
        for k in g0:
            assert torch.equal(g1[k], g0[k]), (mode, "grad", k)
        for k in s0:  # post-Adam parameters, running statistics, batch counts
            assert torch.equal(s1[k], s0[k]), (mode, k)


def test_remat_full_step_matches_jax(jax_dropout_zero):
    """The port's ``full`` step against JAX ``make_train_step(remat="full")``
    (``check_train_step``: loss rtol 1e-5, gradients rtol 1e-3 and atol 1e-3
    of the largest value, 10% in the HRNet trunk, BN statistics rtol 1e-4)."""
    jcfg, jmodel = tiny_jax_model(use_pallas=True)
    variables = random_variables(jmodel, jcfg, seed=3)
    check_train_step(jcfg, jmodel, variables, _raw(presets.from_config(jcfg)), remat="full")


def test_unknown_remat_raises_before_the_build():
    cfg = _cfg("w48", "none", False)
    model = build_model(cfg, device="cpu")
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), 10))
    for bad in ("layer", "everything", "dot"):
        assert bad not in REMAT_VALUES
        with pytest.raises(ValueError, match="DEVICE.REMAT"):
            make_train_step(state, remat=bad)
        for name in MODELS:
            with pytest.raises(ValueError, match="DEVICE.REMAT"):
                build_model(_cfg(name, bad, False), device="cpu")
    for good in REMAT_VALUES:
        make_train_step(state, remat=good)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Calls of the training kernels' wrappers (their plain versions here, a
    launch on a CUDA tensor): the encoders' Kernels C and D, kernel 9."""
    calls = {"C": 0, "D": 0, "9": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    from i2rnet_tpu_torch.ops import attention
    monkeypatch.setattr(attention, "masked_mhsa_train_fused",
                        counted(attention.masked_mhsa_train_fused, "C"))
    monkeypatch.setattr(encoder, "encoder_ffn_train_fused",
                        counted(encoder.encoder_ffn_train_fused, "D"))
    monkeypatch.setattr(hrformer, "window_attn_block_train_fused",
                        counted(hrformer.window_attn_block_train_fused, "9"))
    return calls


@pytest.mark.parametrize("name,layers_", [("w48", 2), ("hrt", 2), ("tph", 2)])
def test_recomputed_regions_run_the_kernels_again(name, layers_, kernel_calls):
    """Each mode runs every training kernel's forward twice a step, once
    with REMAT off (the launches ``chip_smoke.py`` counts on the card)."""
    blocks = len(build_model(_cfg(name, "none", True), device="cpu").singleformer.blocks()) \
        if name == "hrt" else 0
    want = {"C": layers_, "D": layers_, "9": blocks}
    for mode in ("none",) + MODES:
        for k in kernel_calls:
            kernel_calls[k] = 0
        _step(name, mode, True)
        factor = 1 if mode == "none" else 2
        assert kernel_calls == {k: v * factor for k, v in want.items()}, mode


def _saved_bytes(name, remat, monkeypatch):
    """Bytes autograd keeps for the backward of one step: the tensors packed
    outside the recomputed regions, and the products ``dots`` keeps."""
    kept = []

    def pack(t):
        kept.append(t.untyped_storage().nbytes() if t.device.type == "cpu" else 0)
        return t

    keep = layers.save_products_policy

    def policy(ctx, op, *args, **kwargs):
        out = keep(ctx, op, *args, **kwargs)
        if out == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]
            kept.append(a.shape[0] * b.shape[1] * a.element_size())
        return out

    monkeypatch.setattr(layers, "save_products_policy", policy)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _step(name, remat, False)
    return sum(kept)


@pytest.mark.parametrize("name", list(MODELS))
def test_saved_activation_bytes_fall(name, monkeypatch):
    saved = {mode: _saved_bytes(name, mode, monkeypatch) for mode in ("none",) + MODES}
    assert saved["layers"] < saved["none"], saved
    assert saved["full"] < saved["dots"] < saved["none"], saved


@pytest.mark.parametrize("remat,regions", [("layers", 9 + 2), ("full", 1)])
def test_train_loop_reads_remat(remat, regions, tmp_path, monkeypatch):
    """``train_loop`` takes ``DEVICE.REMAT`` from the config (the JAX trainer's
    ``remat=cfg.TPU.REMAT``): two steps of the tiny HRT model recompute its 9
    blocks and 2 inter layers, or the whole step, each step; the final state
    is as with REMAT off."""
    raw = synthetic_raw_batch(MODELS["hrt"](), [3, 2], np.random.RandomState(5), n_max=3,
                              raw_hw=(96, 128))
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or checkpoint(*a, **k))
    states = {}
    for mode in ("none", remat):
        cfg = _cfg("hrt", mode, False)
        states[mode] = train_loop(cfg, str(tmp_path / mode), lambda epoch: [raw, raw],
                                  max_epochs=1, device="cpu").model.state_dict()
    assert len(calls) == 2 * regions
    for k, v in states["none"].items():
        assert torch.equal(states[remat][k], v), k
