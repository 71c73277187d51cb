"""The TransPose-H I²R-Net's training path vs the JAX package, on the CPU, f32.

* The intra encoder's training forward and backward (two layers over the
  tiny model's 16x12 = 192 tokens a person, the sine table added in every
  layer, no key mask, dropout 0.1 at all four sites) against the JAX
  ``TransformerEncoder`` at ``train=True`` with the same explicit bits, on
  both of the port's routes (Kernels C and D, which on CPU tensors are their
  plain versions; and modules). JAX runs its Pallas training kernels in
  interpret mode on either: its module route draws the attention-weight
  dropout inside ``masked_mhsa_xla`` and the tail's two sites in one flax
  ``Dropout`` whose calls cannot be told apart, so the bits are handed to the
  kernels' operands, where each site has its own. The port's sites are
  keyed by their offsets, which checks that intra layer i takes
  ``INTRA_OFFSET_BASE + 4i`` .. ``+ 4i + 3``.
* The dropout keys: the intra and inter encoders' (seed, offset) pairs of
  one training step are disjoint, at the tiny size and the recipe's depth;
  the same step seed gives the same loss twice, another seed another loss.
* One Adam step of the tiny TPH model (``tests/test_torch_transpose_h.py``'s
  JAX config, dropout 0 on both sides) against JAX ``make_train_step`` on one
  common batch with a padded slot, on both routes: the losses, every
  gradient (mapped by ``convert_state_dict(..., "interformer_2stage")``),
  the post-step parameters and the BatchNorm running statistics.
* The first stage's parameters train: ``reduce``, ``final_layer`` and the
  learnable embedding get gradients, the sine table none; ``init_weights``
  draws the learnable embedding from its generator.
* ``train_loop`` on the tiny TPH config, the synthetic batch at the recipe's
  shapes, and the preset's training sections against the JAX preset merged
  with the recipe's YAML.

Tolerances: the encoder, atol 1e-5 / rtol 1e-4 on its output and each
gradient within 1e-4 of its largest magnitude (two frameworks' f32 softmax
and matmul orders). The model step follows
``tests/test_torch_hrformer_train.py``: loss rtol 1e-5, gradients rtol 1e-3
/ atol 1e-3 of the leaf's largest magnitude, post-step parameters by the
resolved-gradient rule, BN statistics rtol 1e-4 / atol 1e-6. ``k_proj``'s
bias is 0 in exact arithmetic (softmax ignores a bias shared by every key):
both sides hold only f32 cancellation noise there, so it is held against
its kernel's gradient scale. The stem (``conv1``, ``conv2``, ``layer1``:
ReLUs over a 3-person batch) counts a gradient as resolved only above 10%
of the leaf's largest value, as in the HRT step test.

No weight seed was picked to keep a ReLU input of the tiny batch away from
its kink: with seeds 1, 2, 3, 30 and 31 alike (measured) JAX and the port
agree on both routes within these tolerances everywhere, the trunk
included. The test uses 31.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import i2rnet_tpu.ops.attention as jatt
import i2rnet_tpu.ops.pallas.encoder_ffn_train as jffn
import i2rnet_tpu_torch.models.encoder as enc
from i2rnet_tpu.config import load_config
from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.core.train import compute_losses as j_compute_losses
from i2rnet_tpu.core.train import make_train_step as j_make_train_step
from i2rnet_tpu.core.train_state import create_train_state, make_optimizer as j_make_optimizer
from i2rnet_tpu.models.encoder import TransformerEncoder as JaxEncoder
from i2rnet_tpu.ops.pallas.encoder_ffn_train import encoder_ffn_train as jax_ffn_train
from i2rnet_tpu.ops.pallas.mhsa_train import DEFAULT_BLOCK_Q
from i2rnet_tpu.ops.pallas.mhsa_train import masked_mhsa_train as jax_mhsa_train
from i2rnet_tpu.ops.preprocess import device_preprocess as j_device_preprocess
from i2rnet_tpu.presets import tph_interformer as jax_tph_preset
from i2rnet_tpu.registry import get_model_builder
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.core.train import make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.trainer import raw_to_device, train_loop
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models.encoder import (INTRA_OFFSET_BASE, OFFSET_LIMIT,
                                             TransformerEncoder)
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.position import sine_position_embedding_2d
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.ops.cuda import launch_counts, reset_launches
from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import (encoder_ffn_train_fused,
                                                         encoder_ffn_train_torch)
from i2rnet_tpu_torch.ops.cuda.mhsa_train import masked_mhsa_train_fused, masked_mhsa_train_torch
from i2rnet_tpu_torch.ops.preprocess import device_preprocess
from i2rnet_tpu_torch.utils.checkpoint import latest_checkpoint, load_checkpoint
from test_torch_bridge import random_variables
from test_torch_train_step import jax_dropout_zero  # noqa: F401  (fixture)
from test_torch_transpose_h import jax_cfg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TPH_YAML = REPO / "experiments" / "coco" / "interformer_coco_tph_192_p4_b4.yaml"
T = torch.from_numpy
RATE = 0.1


def _u32(rng, shape):
    return rng.randint(0, 2 ** 32, size=shape, dtype=np.uint64).astype(np.uint32)


def _bits_t(bits):
    """numpy uint32 bits as the port's int32 pattern."""
    return T(np.ascontiguousarray(bits).view(np.int32))


def _round(n, m):
    return -(-n // m) * m


# ---- the intra encoder under dropout ----------------------------------------

def _site_bits(rng, layers, p, s, c, f, heads):
    """Per layer: the attention-weight bits (JAX's padded [P*H, S_pad, S_pad]),
    the attention-output keep mask [P, S, C] and the tail's two bits arrays
    (JAX's padded [R_pad, F_pad], [R_pad, C_pad])."""
    s_pad, rows = _round(s, DEFAULT_BLOCK_Q), p * s
    return [{"attn": _u32(rng, (p * heads, s_pad, s_pad)),
             "out": rng.rand(p, s, c) >= RATE,
             "ffn": (_u32(rng, (_round(rows, 1024), _round(f, 128))),
                     _u32(rng, (_round(rows, 1024), _round(c, 128))))}
            for _ in range(layers)]


def _patch_jax_sites(monkeypatch, sites):
    """The JAX encoder's dropout sites take ``sites`` in call order: its
    Pallas kernels (interpret mode) the bits, flax ``Dropout`` the keep mask."""
    from flax import linen as fnn

    calls = {"attn": 0, "out": 0, "ffn": 0}

    def take(kind):
        calls[kind] += 1
        return sites[calls[kind] - 1][kind]

    monkeypatch.setattr(jatt, "masked_mhsa_flash_train",
                        lambda q, k, v, h, mask=None, dropout_rate=0.0, dropout_rng=None:
                        jax_mhsa_train(q, k, v, h, key_padding_mask=mask,
                                       dropout_rate=dropout_rate, dropout_bits=take("attn"),
                                       interpret=True))
    # the layer passes (x, 8 parameters, rate, rng) by position
    monkeypatch.setattr(jffn, "encoder_ffn_train_auto",
                        lambda x, *p, eps=1e-5:
                        jax_ffn_train(x, *p[:9], dropout_bits=take("ffn"), eps=eps,
                                      interpret=True))
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, x, deterministic=True, rng=None:
                        x if deterministic else
                        jax.numpy.where(take("out"), x / (1.0 - self.rate), 0.0))
    return calls


def _patch_port_sites(monkeypatch, sites, base, s, f, c):
    """The port encoder's dropout sites take ``sites`` by their offset
    (layer (offset - base) // 4), sliced to the port's unpadded shapes;
    returns the (kind, offset, kernel route) of each call."""
    seen = []

    def layer(offset, site):
        assert (offset - base) % enc.OFFSETS_PER_LAYER == site, (offset, site)
        return sites[(offset - base) // enc.OFFSETS_PER_LAYER]

    def attn(q, k, v, h, mask, rate, seed, offset, use_kernel=False):
        seen.append(("attn", offset, use_kernel))
        bits = _bits_t(layer(offset, 0)["attn"][:, :s, :s])
        fn = masked_mhsa_train_fused if use_kernel else masked_mhsa_train_torch
        return fn(q, k, v, h, mask, rate, dropout_bits=bits)

    def out(x, rate, seed, offset):
        seen.append(("out", offset, None))
        keep = T(layer(offset, 1)["out"])
        return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)

    def tail(fn, kernel):
        def call(x, *p, dropout_rate, dropout_seed, dropout_offset, eps):
            seen.append(("ffn", dropout_offset, kernel))
            rows = x.shape[0] * x.shape[1]
            b1, b2 = layer(dropout_offset, 2)["ffn"]
            bits = (_bits_t(b1[:rows, :f]), _bits_t(b2[:rows, :c]))
            return fn(x, *p, dropout_rate=dropout_rate, dropout_bits=bits, eps=eps)
        return call

    monkeypatch.setattr(enc, "masked_mhsa_train", attn)
    monkeypatch.setattr(enc, "dropout", out)
    monkeypatch.setattr(enc, "encoder_ffn_train_fused", tail(encoder_ffn_train_fused, True))
    monkeypatch.setattr(enc, "encoder_ffn_train_torch", tail(encoder_ffn_train_torch, False))
    return seen


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "modules"])
def test_intra_encoder_training_matches_jax(rng, monkeypatch, kernels):
    """P=3 persons of 16x12 tokens, C=16, 2 heads, F=32, two layers, the
    sine table in every layer, no key mask, dropout 0.1 with the same bits."""
    p, (h, w), c, f, heads, layers = 3, (16, 12), 16, 32, 2, 2
    s = h * w
    x = rng.randn(p, s, c).astype(np.float32)
    cot = rng.randn(p, s, c).astype(np.float32)
    pos = sine_position_embedding_2d(h, w, c)[None]
    sites = _site_bits(rng, layers, p, s, c, f, heads)

    jm = JaxEncoder(layers, heads, f, use_pallas=True)
    variables = jm.init(jax.random.PRNGKey(3), x, None, pos)
    jparams = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(np.float32),
        variables["params"])  # biases and LN offsets away from their init
    calls = _patch_jax_sites(monkeypatch, sites)

    def loss(params, x_):
        out = jm.apply({"params": params}, x_, None, pos, deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jax.numpy.sum(out * cot), out

    (_, ref), (jg, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(jparams, x)
    assert calls == dict.fromkeys(("attn", "out", "ffn"), layers)

    def port_sd(tree):
        full = params_from_jax({"params": {"singleformer": {"trunk": {}, "global_encoder": tree}}},
                               "interformer_2stage")
        return {k[len("singleformer.global_encoder."):]: v for k, v in full.items()}

    model = TransformerEncoder(layers, c, heads, f, use_kernels=kernels,
                               offset_base=INTRA_OFFSET_BASE)
    model.load_state_dict(port_sd(jparams), strict=True)
    model.train()
    seen = _patch_port_sites(monkeypatch, sites, INTRA_OFFSET_BASE, s, f, c)
    xs = T(x).requires_grad_(True)
    reset_launches()
    out = model(xs, None, T(pos), dropout_seed=7)
    (out * T(cot)).sum().backward()
    assert set(launch_counts().values()) == {0}  # CPU tensors: the plain versions
    assert seen == [(kind, INTRA_OFFSET_BASE + 4 * i + site, route)
                    for i in range(layers)
                    for kind, site, route in (("attn", 0, kernels), ("out", 1, None),
                                              ("ffn", 2, kernels))]

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xs.grad.numpy(), np.asarray(jgx), rtol=1e-4, atol=1e-5)
    want = {k: v.numpy() for k, v in port_sd(jg).items()}
    for n, prm in model.named_parameters():
        scale = want[n.replace("in_proj_bias", "in_proj_weight")]  # k's bias: 0 exactly
        err = np.abs(prm.grad.numpy() - want[n]).max()
        assert err <= 1e-4 * np.abs(scale).max() + 1e-7, (n, err)


# ---- the dropout keys --------------------------------------------------------

def _spy_keys(monkeypatch, model):
    """Record the (seed, offset) of every dropout site each encoder of
    ``model`` keys, by encoder (forward hooks mark which one runs)."""
    keys, current = {"intra": set(), "inter": set()}, []
    for label, encoder in zip(("intra", "inter"), model.encoders()):
        encoder.register_forward_pre_hook(lambda _m, _a, label=label: current.append(label))
        encoder.register_forward_hook(lambda _m, _a, _o: current.pop() and None)
    attn, drop = enc.masked_mhsa_train, enc.dropout
    ffn_k, ffn_t = enc.encoder_ffn_train_fused, enc.encoder_ffn_train_torch

    def spy_attn(*a, **k):
        keys[current[-1]].add((a[6], a[7]))
        return attn(*a, **k)

    def spy_drop(x, rate, seed, offset):
        keys[current[-1]].add((seed, offset))
        return drop(x, rate, seed, offset)

    def spy_ffn(fn):
        def call(*a, **k):
            keys[current[-1]].update({(k["dropout_seed"], k["dropout_offset"]),
                                      (k["dropout_seed"], k["dropout_offset"] + 1)})
            return fn(*a, **k)
        return call

    monkeypatch.setattr(enc, "masked_mhsa_train", spy_attn)
    monkeypatch.setattr(enc, "dropout", spy_drop)
    monkeypatch.setattr(enc, "encoder_ffn_train_fused", spy_ffn(ffn_k))
    monkeypatch.setattr(enc, "encoder_ffn_train_torch", spy_ffn(ffn_t))
    return keys


def _tiny_step_model(cfg, seed=0):
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), steps_per_epoch=1))
    return state, make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"])


def _tiny_batch(cfg, counts=(2, 1), n_max=2, seed=5):
    m = cfg["MODEL"]
    raw = synthetic_raw_batch(cfg, list(counts), np.random.RandomState(seed), n_max=n_max,
                              raw_hw=(96, 128))
    return device_preprocess(raw_to_device(raw, "cpu"), tuple(m["IMAGE_SIZE"]),
                             tuple(m["HEATMAP_SIZE"]), m["SIGMA"])


@pytest.mark.parametrize("kernels", [True, False], ids=["kernels", "modules"])
def test_dropout_keys_are_disjoint_and_repeatable(monkeypatch, kernels):
    """One tiny TPH training step: each encoder keys 4 sites a layer with the
    step's seed, on offsets disjoint from the other's; the same step seed
    gives the same loss, another seed another loss. The recipe's encoders (6
    intra, 4 inter layers) take disjoint offsets below the limit."""
    cfg = presets.tiny_tph_config(5)
    cfg["DEVICE"]["USE_KERNELS"] = kernels
    batch = _tiny_batch(cfg)
    losses = []
    for step_seed in (3, 3, 4):
        state, step = _tiny_step_model(cfg)
        keys = _spy_keys(monkeypatch, state.model)
        losses.append(step(batch, torch.Generator().manual_seed(step_seed))["loss"].item())
        assert {s for s, _ in keys["intra"] | keys["inter"]} == {
            next(iter(keys["intra"]))[0]}  # one seed, the step's
        assert {o for _, o in keys["intra"]} == set(state.model.encoders()[0].offsets())
        assert {o for _, o in keys["inter"]} == set(state.model.encoders()[1].offsets())
        assert not keys["intra"] & keys["inter"] and len(keys["intra"]) == 4
        monkeypatch.undo()
    assert losses[0] == losses[1] and losses[2] != losses[0]
    intra, inter = build_model(presets.tph_interformer(), device="cpu").encoders()
    assert (list(intra.offsets()), list(inter.offsets())) == (
        list(range(INTRA_OFFSET_BASE, INTRA_OFFSET_BASE + 24)), list(range(16)))
    assert max(intra.offsets()) < OFFSET_LIMIT
    with pytest.raises(ValueError, match="limit"):
        TransformerEncoder(32, 16, 2, 32, offset_base=INTRA_OFFSET_BASE)
    cfg["MODEL"]["ENCODER_MULTI_LAYERS"] = 33
    with pytest.raises(ValueError, match="first stage"):
        build_model(cfg, device="cpu")


# ---- one Adam step against JAX make_train_step -------------------------------

def _jax_tph(cfg, fused):
    return get_model_builder(cfg.MODEL.NAME)(cfg, use_pallas=fused)


def _sd_numpy(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _tree(sd):
    variables, unmatched = convert_state_dict(sd, "interformer_2stage")
    assert not unmatched
    return variables


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


#: the stem's leaves (module docstring)
_STEM = ("['singleformer']['trunk']['conv1']", "['singleformer']['trunk']['conv2']",
         "['singleformer']['trunk']['layer1")


def _grad_atol(name, ref, flat):
    if name.endswith("['k_proj']['bias']"):  # 0 in exact arithmetic
        return 1e-3 * np.abs(flat[name[:-len("['bias']")] + "['kernel']"]).max() + 1e-8
    return 1e-3 * np.abs(ref).max() + 1e-8


@pytest.mark.parametrize("fused", [True, False], ids=["kernels", "modules"])
def test_train_step_matches_jax(jax_dropout_zero, monkeypatch, fused):  # noqa: F811
    """One Adam step on one common batch (2 images x 2 slots, 3 persons)."""
    xla = jatt.masked_mhsa_xla  # the unfused encoder's attention-weight dropout, rate 0
    monkeypatch.setattr(jatt, "masked_mhsa_xla",
                        lambda q, k, v, h, mask=None, dropout_rate=0.0, dropout_rng=None:
                        xla(q, k, v, h, mask))
    jcfg = jax_cfg()
    jcfg.TPU.USE_PALLAS_ATTENTION = fused
    cfg = presets.from_config(jcfg)
    m = cfg["MODEL"]
    raw = synthetic_raw_batch(cfg, [2, 1], np.random.RandomState(5), n_max=2, raw_hw=(96, 128))
    jbatch = j_device_preprocess(raw, tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]),
                                 m["SIGMA"])
    jmodel = _jax_tph(jcfg, fused)
    variables = random_variables(jmodel, jcfg, seed=31)
    tx, jsched = j_make_optimizer(jcfg, steps_per_epoch=1)
    jstate = create_train_state(jmodel, variables, tx)
    jstep = j_make_train_step(jmodel, tx, loss_weights=m["LOSS_WEIGHTS"], donate=False)
    new_jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(0))

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jbatch["images"], jbatch["pos_masks"], jbatch["person_valid"],
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return j_compute_losses(out, jbatch, m["LOSS_WEIGHTS"], True)[0]

    jgrads = jax.jit(jax.grad(j_loss))(variables["params"])

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, "interformer_2stage"), strict=True)
    assert [e.use_kernels for e in model.encoders()] == [fused, fused]
    for encoder in model.encoders():
        assert encoder.flash_train and encoder.fused_ffn_train
        encoder.dropout_rate = 0.0
    state = TrainState(model, *make_optimizer(cfg, model.parameters(), steps_per_epoch=1))
    step = make_train_step(state, m["LOSS_WEIGHTS"], cfg["LOSS"]["USE_TARGET_WEIGHT"])
    batch = {k: T(np.array(v)) for k, v in jbatch.items()}
    assert not batch["person_valid"].all()
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


# ---- the first stage's parameters, the trainer, the data and the preset -----

@pytest.mark.parametrize("pos_embedding", ["sine", "learnable"])
def test_first_stage_parameters_train(pos_embedding):
    """A training step's gradients reach the first stage's ``reduce``,
    ``final_layer`` and, where it is a parameter, the embedding; the sine
    table stays a buffer out of the state dict and gets none.
    ``init_weights`` draws the learnable embedding from its generator, N(0, 1)
    as the JAX parameter."""
    cfg = presets.tiny_tph_config(5)
    cfg["MODEL"]["POS_EMBEDDING"] = pos_embedding
    state, step = _tiny_step_model(cfg)
    tph = state.model.singleformer
    pe = tph.pos_embedding.detach().clone()
    again = build_model(cfg, device="cpu")
    init_weights(again, torch.Generator().manual_seed(0))
    assert torch.equal(again.singleformer.pos_embedding, pe)
    step(_tiny_batch(cfg), torch.Generator().manual_seed(0))
    for name in ("reduce", "final_layer"):
        grad = getattr(tph, name).weight.grad
        assert grad is not None and grad.abs().max() > 0, name
    learnable = pos_embedding == "learnable"
    assert isinstance(tph.pos_embedding, torch.nn.Parameter) == learnable
    assert ("singleformer.pos_embedding" in state.model.state_dict()) == learnable
    if learnable:
        assert tph.pos_embedding.grad.abs().max() > 0
        assert not torch.equal(tph.pos_embedding.detach(), pe)  # Adam moved it
        assert abs(float(pe.std()) - 1.0) < 0.1
    else:
        assert tph.pos_embedding.grad is None and not tph.pos_embedding.requires_grad
        assert torch.equal(tph.pos_embedding, pe)


def test_train_loop_trains_the_tph_model(tmp_path):
    """Two epochs of two steps of the tiny TPH model (dropout 0.1, kernel
    routes on: their plain versions on CPU tensors, no launch counted), the
    ``single`` loss reported, its checkpoints, and AUTO_RESUME restoring
    weights, optimizer state and step bit for bit."""
    cfg = presets.tiny_tph_config(5)
    cfg["DEVICE"]["USE_KERNELS"] = True
    cfg["PRINT_FREQ"] = 1
    raw = synthetic_raw_batch(cfg, [3, 0, 1], np.random.RandomState(5), n_max=3,
                              raw_hw=(96, 128))
    losses = []
    reset_launches()
    state = train_loop(cfg, str(tmp_path), lambda epoch: [raw, raw], max_epochs=2, device="cpu",
                       on_step=lambda e, i, mt: losses.append(
                           (float(mt["loss"]), float(mt["loss_single"]), float(mt["acc"]))))
    assert set(launch_counts().values()) == {0}
    assert len(losses) == 4 and all(np.isfinite(v).all() for v in losses) and state.step == 4
    payload = load_checkpoint(latest_checkpoint(str(tmp_path)))
    assert payload["epoch"] == 1 and payload["meta"]["model"] == "interformer_2stage"
    resumed = train_loop(cfg, str(tmp_path), lambda epoch: [raw, raw], max_epochs=2,
                         device="cpu")
    assert resumed.step == 4
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, payload["state_dict"][k]), k
    a, b = resumed.optimizer.state_dict(), state.optimizer.state_dict()
    for k in b["state"]:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(a["state"][k][name], b["state"][k][name])


def test_synthetic_batch_serves_the_tph_config():
    """256x192, MAX_PATCH 4 and an empty image: the raw batch and its
    preprocessing have the recipe's shapes, padded slots invalid."""
    cfg = presets.tph_interformer()
    raw = synthetic_raw_batch(cfg, [4, 0, 2, 1], np.random.RandomState(0), raw_hw=(240, 320))
    assert raw["images"].shape == (4, 240, 320, 3) and raw["joints_hm"].shape == (4, 4, 17, 2)
    np.testing.assert_array_equal(raw["person_valid"].sum(1), [4, 0, 2, 1])
    m = cfg["MODEL"]
    batch = device_preprocess(raw_to_device(raw, "cpu"), tuple(m["IMAGE_SIZE"]),
                              tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    assert tuple(batch["images"].shape) == (4, 4, 256, 192, 3)
    assert tuple(batch["target"].shape) == (4, 4, 17, 64, 48)
    assert not batch["target"][~batch["person_valid"]].any()
    assert batch["target"][batch["person_valid"]].amax((1, 2, 3)).min() > 0.5


def test_preset_training_sections_are_the_jax_presets_with_the_yaml():
    """``TRAIN``, ``LOSS`` and the top-level keys of ``presets.tph_interformer``
    equal the JAX preset's with the recipe's YAML merged over it (and
    ``load_config`` of the YAML alone)."""
    merged = jax_tph_preset("coco", 4)
    merged.merge(yaml.safe_load(TPH_YAML.read_text()))
    want = presets.tph_interformer()
    for jcfg in (merged, load_config(str(TPH_YAML))):
        got = presets.from_config(jcfg)
        for sec in ("TRAIN", "LOSS"):
            assert got[sec] == want[sec], sec
        for key in ("SEED", "AUTO_RESUME", "PRINT_FREQ", "WORKERS"):
            assert got[key] == want[key], key
        assert (got["DEVICE"]["FLASH_TRAIN_ATTENTION"], got["DEVICE"]["FUSED_FFN_TRAIN"],
                got["MODEL"]["LOSS_WEIGHTS"]) == (True, True, [0.5, 0.5])
    t = want["TRAIN"]
    assert (t["OPTIMIZER"], t["LR"], t["BATCH_SIZE_PER_GPU"], want["DATASET"]["MAX_PATCH"]) == (
        "adam", 1e-4, 4, 4)
