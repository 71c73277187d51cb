"""The folded eval conv units and their epilogue (``ops/cuda/conv_epilogue.py``)
on the CPU, where the kernel's wrapper takes its plain version.

* the plain epilogue against ``act(y + bias (+ residual))`` written out, in
  all four residual / ReLU variants, float32 and bfloat16, on channels-last
  strides; the kernel's vector width;
* each unit kind (``ConvBN`` with and without ReLU, ``BasicBlock`` with and
  without downsample, ``Bottleneck``, the HRNet stem) folded against its
  unfused eval path, float32, with random running statistics and affine
  parameters (the initial 0, 1, 1, 0 would make the fold the identity and
  hide a wrong one): within 1e-5 of the output's scale, channels-last;
* the fold follows its five tensors from one forward to the next; it
  switches no grad mode where gradients are off (an exported forward);
* routing: a training forward (and an eval forward that needs gradients)
  runs no epilogue and moves the running statistics; an eval forward without
  gradients runs one per conv unit, through the kernel's route under the
  model's kernel switch.

The folded trunk against the JAX package is ``test_torch_pure_multi.py``
(and the TPH and HRT model tests), which run their eval forwards without
gradients; the exported W48 artifact's ``i2r::conv_epilogue`` nodes are
``test_torch_serving_artifact.py``'s.
"""

import itertools

import numpy as np
import pytest
import torch

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.models import layers
from i2rnet_tpu_torch.models.hrnet import HRStem
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.layers import (BasicBlock, Bottleneck, ConvBN, ConvUnits,
                                            MaskedBatchNorm, fold_bn, set_conv_kernels)
from i2rnet_tpu_torch.ops.cuda import library
from i2rnet_tpu_torch.ops.cuda.conv_epilogue import (conv_epilogue_fused, conv_epilogue_torch,
                                                     vector_width)

torch.set_num_threads(2)

CL = torch.channels_last
TOL = 1e-5  # of the output's largest magnitude: f32 rounds the folded products apart


def _randomise_bns(module, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, MaskedBatchNorm):
                c = m.num_features
                m.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                m.running_var.copy_(torch.rand(c, generator=g) + 0.25)
                m.weight.copy_(torch.rand(c, generator=g) + 0.5)
                m.bias.copy_(0.2 * torch.randn(c, generator=g))
            elif isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               / np.sqrt(m.weight[0].numel()))
    return module.eval()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("res,relu", list(itertools.product([False, True], [False, True])),
                         ids=["plain", "relu", "residual", "residual-relu"])
def test_plain_epilogue_is_the_formula(dtype, res, relu):
    g = torch.Generator().manual_seed(1)
    y = torch.randn(3, 12, 5, 4, generator=g).to(dtype).contiguous(memory_format=CL)
    r = torch.randn(3, 12, 5, 4, generator=g).to(dtype).contiguous(memory_format=CL)
    b = torch.randn(12, generator=g)
    z = y.float() + b[:, None, None]
    if res:
        z = z + r.float()
    want = (z.clamp_min(0) if relu else z).to(dtype)
    got = conv_epilogue_torch(y, b, r if res else None, relu)
    assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
    assert torch.equal(got, want)
    # the kernel's wrapper takes the plain version on the CPU
    assert torch.equal(conv_epilogue_fused(y, b, r if res else None, relu), got)


@pytest.mark.parametrize("c,dtype,want", [
    (48, torch.bfloat16, 8), (64, torch.bfloat16, 8), (78, torch.bfloat16, 2),
    (156, torch.bfloat16, 4), (3, torch.bfloat16, 1), (48, torch.float32, 4),
    (78, torch.float32, 2), (96, torch.float32, 4)])
def test_vector_width_follows_c(c, dtype, want):
    y = torch.empty(2, c, 3, 3, dtype=dtype).contiguous(memory_format=CL)
    assert vector_width(c, y.element_size(), y) == want


def test_vector_width_follows_alignment():
    """A view that starts one element into its storage takes one-element loads."""
    flat = torch.empty(2 * 48 * 9 + 8, dtype=torch.bfloat16)
    aligned = flat[:2 * 48 * 9]
    shifted = flat[1:1 + 2 * 48 * 9]
    assert vector_width(48, 2, aligned) == 8
    assert vector_width(48, 2, aligned, shifted) == 1
    assert vector_width(48, 2, flat[4:4 + 2 * 48 * 9]) == 4


def _units():
    torch.manual_seed(0)
    return {
        "convbn-relu": (ConvBN(6, 10, 3, 2), (2, 6, 9, 7)),
        "convbn": (ConvBN(6, 10, 1, relu=False), (2, 6, 9, 7)),
        "basic": (BasicBlock(8, 8), (2, 8, 6, 5)),
        "basic-downsample": (BasicBlock(6, 8, downsample=True), (2, 6, 6, 5)),
        "bottleneck-downsample": (Bottleneck(8, 4, downsample=True), (2, 8, 6, 5)),
        "bottleneck": (Bottleneck(16, 4), (2, 16, 6, 5)),
        "stem": (HRStem(), (2, 3, 32, 24)),
    }


def _count_epilogues(monkeypatch):
    """The shapes of the plain epilogues the folded units run."""
    calls, real = [], layers.conv_epilogue_torch
    monkeypatch.setattr(layers, "conv_epilogue_torch",
                        lambda y, *a: calls.append(y.shape) or real(y, *a))
    return calls


@pytest.mark.parametrize("name", list(_units()))
def test_folded_unit_matches_the_unfused_path(name, monkeypatch):
    calls = _count_epilogues(monkeypatch)
    unit, shape = _units()[name]
    _randomise_bns(unit, seed=len(name))
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g).contiguous(memory_format=CL)
    want = unit(x)  # grad mode with parameters that want it: today's path
    assert want.requires_grad
    bns = [m for m in unit.modules() if isinstance(m, MaskedBatchNorm)]
    assert calls == []
    with torch.no_grad():
        got = unit(x)
    assert len(calls) == len(bns)  # every unit ran folded
    assert got.is_contiguous(memory_format=CL)
    scale = want.abs().max().item()
    assert scale > 0.1
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=TOL * scale)
    set_conv_kernels(unit, True)  # the kernel's route: its plain version on the CPU
    with torch.no_grad():
        assert torch.equal(unit(x), got)


def test_fold_is_the_batchnorm():
    conv = layers.Conv2d(4, 6, 3, 1, 1, bias=False)
    bn = _randomise_bns(MaskedBatchNorm(6))
    w, b = fold_bn(conv, bn, torch.bfloat16)
    k = bn.weight / torch.sqrt(bn.running_var + bn.eps)
    assert w.dtype == torch.bfloat16 and w.is_contiguous(memory_format=CL)
    torch.testing.assert_close(w.float(), (conv.weight * k[:, None, None, None]).detach(),
                               rtol=2 ** -8, atol=0)
    assert b.dtype == torch.float32
    torch.testing.assert_close(b, (bn.bias - bn.running_mean * k).detach(), rtol=1e-6,
                               atol=1e-7)


def test_fold_follows_its_tensors():
    unit = _randomise_bns(ConvBN(4, 6, 3))
    conv, bn = unit[0], unit[1]
    assert fold_bn(conv, bn, torch.bfloat16)[0].dtype == torch.bfloat16
    x = torch.randn(1, 4, 5, 5)
    with torch.no_grad():
        first = unit(x)
    for tensor in (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var):
        with torch.no_grad():
            tensor.mul_(1.5)
        with torch.no_grad():
            got = unit(x)
        assert not torch.equal(got, first)
        want = unit(x)  # unfused, from the tensors as they are now
        torch.testing.assert_close(got, want.detach(), rtol=0,
                                   atol=TOL * want.abs().max().item())
    state = {k: v * 0.5 for k, v in unit.state_dict().items()}
    unit.load_state_dict(state)
    with torch.no_grad():
        got = unit(x)
    want = unit(x)
    torch.testing.assert_close(got, want.detach(), rtol=0, atol=TOL * want.abs().max().item())


def test_folded_unit_switches_no_grad_mode(monkeypatch):
    """Without gradients the fold leaves grad mode alone: inside a forward
    that ``torch.export`` traces, each switch splits the graph, and the
    export spent minutes inlining 160 of them back."""
    calls = _count_epilogues(monkeypatch)
    unit = _randomise_bns(ConvBN(4, 6, 3))
    switches, real = [], torch._C._set_grad_enabled
    monkeypatch.setattr(torch._C, "_set_grad_enabled",
                        lambda mode: switches.append(mode) or real(mode))
    with torch.no_grad():
        entered = len(switches)
        unit(torch.randn(1, 4, 5, 5))
        assert len(switches) == entered
    assert len(calls) == 1  # it ran folded


@pytest.fixture()
def tiny_w48():
    model = build_model(presets.tiny_test_config(5), use_kernels=True, device="cpu")
    return _randomise_bns(model, seed=7)


def _trunk_units(model):
    """The conv units of the trunk: one BatchNorm each."""
    return sum(isinstance(m, MaskedBatchNorm) for name, m in model.named_modules()
               if name.startswith(("bn", "layer1", "transition", "stage")))


def _spy(monkeypatch):
    calls = []
    wrapper, op = library.ROUTES["conv_epilogue"]

    def spy(*args):
        calls.append(args[0].shape)
        return wrapper(*args)

    monkeypatch.setitem(library.ROUTES, "conv_epilogue", (spy, op))
    return calls


def _inputs(b=2, n=2):
    g = torch.Generator().manual_seed(5)
    return (torch.randn(b, n, 64, 48, 3, generator=g), torch.rand(b, n, 64, 48, 1, generator=g),
            torch.ones(b, n, dtype=torch.bool))


def test_eval_runs_one_epilogue_per_conv_unit(tiny_w48, monkeypatch):
    calls = _spy(monkeypatch)
    assert all(m.use_kernels for m in tiny_w48.modules() if isinstance(m, ConvUnits))
    with torch.no_grad():
        tiny_w48(*_inputs())
    assert len(calls) == _trunk_units(tiny_w48) == 37
    tiny_w48.set_kernels(False)  # the plain version, no route
    calls.clear()
    with torch.no_grad():
        tiny_w48(*_inputs())
    assert calls == []


def test_training_and_gradients_take_the_unfused_path(tiny_w48, monkeypatch):
    calls = _spy(monkeypatch)
    images, pos, valid = _inputs()
    heat = tiny_w48(images, pos, valid)  # eval, but gradients wanted
    assert heat.requires_grad and calls == []
    bns = [m for m in tiny_w48.modules() if isinstance(m, MaskedBatchNorm)]
    before = [bn.running_mean.clone() for bn in bns]
    tiny_w48(images, pos, valid, train=True, dropout_seed=3).sum().backward()
    assert calls == []
    assert not tiny_w48.training  # restored after the call
    assert all(not torch.equal(bn.running_mean, b) for bn, b in zip(bns, before))
    # once a training forward (the deconv block, applied twice, twice)
    assert all(bn.num_batches_tracked.item() >= 1 for bn in bns)
    assert all(m.num_batches_tracked.item() == 1 for name, m in tiny_w48.named_modules()
               if isinstance(m, MaskedBatchNorm) and name.startswith(("bn", "layer1", "stage")))
