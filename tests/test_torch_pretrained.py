"""First-stage and backbone weights, and frozen training, against the JAX package.

* ``core/pretrained.py::load_pretrained`` grafts what the JAX
  ``load_pretrained`` grafts, exactly: on the tiny TPH and HRT two-stage
  models a ``.pth`` of another seed's first stage (``MODEL.SINGLE_MODEL``)
  into ``singleformer``, on the tiny W48 a whole model's (``PRETRAINED``
  under ``INIT_WEIGHTS``) at the root; each file wrapped in
  ``state_dict``/``best_state_dict``, its names prefixed ``module.``, with
  tensors the model lacks and without some it has. The JAX side runs its
  own converter on the same file; its tree, through ``params_from_jax``,
  equals the port's state dict bit for bit. A shape mismatch and a missing
  file raise in both; a two-stage run without ``SINGLE_MODEL`` only warns.
* ``freeze`` freezes the parameters the JAX ``frozen_predicate_for_cfg``
  masks (``SINGLEFORMER_FIX``, ``BACKBONE_FIX``), on all three models.
* One Adam step with ``SINGLEFORMER_FIX`` (TPH, with and without
  ``FROZEN_STAGE_EVAL_MODE``) and with ``BACKBONE_FIX`` (W48) against the
  JAX ``make_train_step`` with the frozen predicate, dropout 0, on one
  common batch: frozen parameters bit-equal before and after on both
  sides; the loss (no first-stage term under ``SINGLEFORMER_FIX``) rtol
  1e-5; the trainable gradients rtol 1e-3 / atol 1e-3 of the leaf's largest
  value (``k_proj``'s bias, 0 in exact arithmetic, against its kernel's);
  post-step parameters by the resolved-gradient rule of
  ``test_torch_train_step.py``; BN statistics rtol 1e-4 / atol 1e-6, the
  frozen stage's included (they move in training mode, and stay under
  ``FROZEN_STAGE_EVAL_MODE``).
"""

import logging

import jax
import numpy as np
import pytest
import torch

import i2rnet_tpu.ops.attention as jatt
from i2rnet_tpu.config.config import default_config as jax_default_config
from i2rnet_tpu.convert.torch_import import convert_state_dict
from i2rnet_tpu.core.pretrained import frozen_predicate_for_cfg
from i2rnet_tpu.core.pretrained import load_pretrained as jax_load_pretrained
from i2rnet_tpu.core.train import compute_losses as j_compute_losses
from i2rnet_tpu.core.train import make_train_step as j_make_train_step
from i2rnet_tpu.core.train_state import create_train_state, make_optimizer as j_make_optimizer
from i2rnet_tpu.ops.preprocess import device_preprocess as j_device_preprocess
from i2rnet_tpu.registry import get_model_builder
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.convert.jax_import import params_from_jax
from i2rnet_tpu_torch.core.pretrained import (freeze, frozen_names, load_model_file,
                                              load_pretrained)
from i2rnet_tpu_torch.core.train import make_train_step
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from test_torch_bridge import random_variables, tiny_jax_model
from test_torch_train_step import jax_dropout_zero  # noqa: F401  (fixture)
from test_torch_transpose_h import jax_cfg as tph_jax_cfg

torch.set_num_threads(2)

#: the tiny models: (port config maker, model name, first stage's name)
MODELS = {"tph": (lambda: presets.tiny_tph_config(5), "interformer_2stage", "transpose_h"),
          "hrt": (lambda: presets.tiny_hrt_config(5), "interformer", "hrformer"),
          "w48": (lambda: presets.tiny_test_config(5), "interformer_pureMulti", None)}


def _model(kind, seed):
    cfg = MODELS[kind][0]()
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return cfg, model


def _numpy(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _jax_cfg(**model):
    cfg = jax_default_config()
    for k, v in model.items():
        setattr(cfg.MODEL, k, v)
    return cfg


def _source(kind, path, wrap, drop=2, extra=True):
    """A ``.pth`` from another seed: the first stage's state dict (two-stage)
    or the whole model's, ``module.``-prefixed, ``drop`` of its parameters
    left out, two tensors the model does not have added, in ``wrap``.
    Returns the names left out."""
    _, other = _model(kind, seed=7)
    sd = (other.singleformer if MODELS[kind][2] else other).state_dict()
    sd = {k: v.clone() for k, v in sd.items()}
    left_out = [k for k in sd if k.endswith("weight")][1:1 + drop]
    for k in left_out:
        del sd[k]
    if extra:
        sd["aux_head.0.weight"] = torch.ones(3, 3)
        sd["head.extra.bias"] = torch.zeros(5)
    sd = {f"module.{k}": v for k, v in sd.items()}
    torch.save({wrap: sd, "epoch": 3} if wrap else sd, path)
    return left_out


def _load_both(kind, path, **model_keys):
    """Both loaders on the same freshly initialised weights: (port state
    dict, JAX tree through ``params_from_jax``, the initial state dict)."""
    make, name, first = MODELS[kind]
    cfg, model = _model(kind, seed=0)
    init = _numpy(model.state_dict())
    keys = ({"SINGLEFORMER": first, "SINGLE_MODEL": str(path)} if first
            else {"SINGLEFORMER": None, "INIT_WEIGHTS": True, "PRETRAINED": str(path)})
    keys.update(model_keys)
    cfg["MODEL"].update(keys)
    variables, unmatched = convert_state_dict(init, name)
    assert not unmatched
    jax_load_pretrained(_jax_cfg(NAME=name, **keys), variables)
    load_pretrained(cfg, model)
    return model.state_dict(), params_from_jax(variables, name), init


@pytest.mark.parametrize("kind,wrap", [("tph", "state_dict"), ("hrt", "best_state_dict"),
                                       ("w48", "best_state_dict"), ("tph", None)])
def test_load_pretrained_grafts_what_jax_grafts(tmp_path, kind, wrap):
    path = tmp_path / "source.pth"
    left_out = _source(kind, path, wrap)
    port, jax_sd, init = _load_both(kind, path)
    assert set(jax_sd) <= set(port)
    for k, v in jax_sd.items():
        assert torch.equal(port[k], v), k
    prefix = "singleformer." if MODELS[kind][2] else ""
    moved = [k for k in port if k.startswith(prefix) and not np.array_equal(port[k].numpy(),
                                                                            init[k])]
    assert len(moved) > 20
    for k in left_out:  # not in the file: as initialised
        np.testing.assert_array_equal(port[prefix + k].numpy(), init[prefix + k])
    if prefix:  # nothing outside the first stage moves
        assert all(k.startswith(prefix) for k in moved)


@pytest.mark.parametrize("kind", list(MODELS))
def test_a_shape_mismatch_raises_in_both(tmp_path, kind):
    path = tmp_path / "bad.pth"
    _, other = _model(kind, seed=7)
    sd = dict((other.singleformer if MODELS[kind][2] else other).state_dict())
    name = next(k for k in sd if k.endswith("final_layer.weight"))
    sd[name] = torch.zeros(sd[name].shape[0] + 1, *sd[name].shape[1:])
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match="shape mismatch") as port:
        _load_both(kind, path)
    assert "final_layer" in str(port.value)
    _, mname, first = MODELS[kind]
    keys = ({"SINGLEFORMER": first, "SINGLE_MODEL": str(path)} if first
            else {"SINGLEFORMER": None, "PRETRAINED": str(path)})
    variables, _ = convert_state_dict(_numpy(_model(kind, 0)[1].state_dict()), mname)
    with pytest.raises(ValueError, match="shape mismatch"):
        jax_load_pretrained(_jax_cfg(NAME=mname, **keys), variables)


@pytest.mark.parametrize("kind", list(MODELS))
def test_a_missing_file_raises_in_both(tmp_path, kind):
    _, name, first = MODELS[kind]
    missing = str(tmp_path / "nowhere.pth")
    keys = ({"SINGLEFORMER": first, "SINGLE_MODEL": missing} if first
            else {"SINGLEFORMER": None, "PRETRAINED": missing})
    cfg, model = _model(kind, 0)
    cfg["MODEL"].update(keys)
    with pytest.raises(ValueError, match="does not exist") as port:
        load_pretrained(cfg, model)
    with pytest.raises(ValueError, match="does not exist") as jax_err:
        jax_load_pretrained(_jax_cfg(NAME=name, **keys), {"params": {}, "batch_stats": {}})
    assert str(port.value) == str(jax_err.value)


def test_two_stage_without_single_model_only_warns(caplog):
    cfg, model = _model("tph", 0)
    before = _numpy(model.state_dict())
    cfg["MODEL"].update(SINGLEFORMER="transpose_h", SINGLE_MODEL="")
    with caplog.at_level(logging.WARNING):
        load_pretrained(cfg, model)
    assert any("RANDOM weights" in r.message for r in caplog.records)
    assert all(np.array_equal(v.numpy(), before[k]) for k, v in model.state_dict().items())
    # INIT_WEIGHTS false: no backbone file is read, present or not
    cfg, model = _model("w48", 0)
    cfg["MODEL"].update(INIT_WEIGHTS=False, PRETRAINED="/nowhere.pth")
    load_pretrained(cfg, model)


def test_load_model_file_takes_every_tensor_or_raises(tmp_path):
    _, src = _model("hrt", 7)
    torch.save({"state_dict": {f"module.{k}": v for k, v in src.state_dict().items()}},
               tmp_path / "m.pth")
    _, model = _model("hrt", 0)
    load_model_file(str(tmp_path / "m.pth"), model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    sd = dict(src.state_dict())
    del sd["final_layer.weight"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="lacks 1 tensors"):
        load_model_file(str(tmp_path / "short.pth"), model)
    with pytest.raises(FileNotFoundError):
        load_model_file(str(tmp_path / "none.pth"), model)


@pytest.mark.parametrize("kind,keys,some", [
    ("tph", {"SINGLEFORMER_FIX": True}, True), ("tph", {"BACKBONE_FIX": True}, True),
    ("hrt", {"SINGLEFORMER_FIX": True}, True), ("hrt", {"BACKBONE_FIX": True}, False),
    ("w48", {"BACKBONE_FIX": True}, True), ("w48", {"SINGLEFORMER_FIX": True}, False)])
def test_frozen_parameters_are_the_jax_predicates(kind, keys, some):
    """Ones where the JAX predicate freezes a leaf, zeros elsewhere, through
    ``params_from_jax``: the all-ones tensors are the port's frozen ones.
    ``BACKBONE_FIX`` freezes nothing of the HRFormer first stage (the JAX
    predicate matches ``trunk``/``backbone`` subtrees, which it has not),
    and ``SINGLEFORMER_FIX`` nothing of a model without a first stage."""
    make, name, first = MODELS[kind]
    cfg, model = _model(kind, 0)
    cfg["MODEL"].update(SINGLEFORMER=first, **keys)
    variables, _ = convert_state_dict(_numpy(model.state_dict()), name)
    pred = frozen_predicate_for_cfg(_jax_cfg(NAME=name, SINGLEFORMER=first, **keys))
    flags = jax.tree_util.tree_map_with_path(
        lambda p, x: np.full(np.shape(x), float(bool(pred and pred(p))), np.float32),
        variables["params"])
    marked = params_from_jax({"params": flags, "batch_stats": jax.tree_util.tree_map(
        np.zeros_like, variables["batch_stats"])}, name)
    params = dict(model.named_parameters())
    want = {k for k, v in marked.items() if k in params and bool((v == 1).all())}
    assert set(frozen_names(cfg, model)) == want
    assert (len(want) > 0) == some
    freeze(cfg, model)
    assert {k for k, p in params.items() if not p.requires_grad} == want


# ---- one frozen Adam step against JAX make_train_step -------------------------

def _grad_atol(name, ref, flat):
    if name.endswith("['k_proj']['bias']"):  # 0 in exact arithmetic
        return 1e-3 * np.abs(flat[name[:-len("['bias']")] + "['kernel']"]).max() + 1e-8
    return 1e-3 * np.abs(ref).max() + 1e-8


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float64)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def frozen_step(jcfg, jmodel, variables, raw):
    """One Adam step on both sides with the config's frozen parameters; the
    comparisons of the module docstring."""
    name = jcfg.MODEL.NAME
    cfg = presets.from_config(jcfg)
    m = cfg["MODEL"]
    jbatch = j_device_preprocess(raw, tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]),
                                 m["SIGMA"])
    pred = frozen_predicate_for_cfg(jcfg)
    tx, _ = j_make_optimizer(jcfg, steps_per_epoch=1)
    jstate = create_train_state(jmodel, variables, tx, frozen_predicate=pred)
    jstep = j_make_train_step(jmodel, tx, loss_weights=m["LOSS_WEIGHTS"], donate=False,
                              frozen_predicate=pred)
    new_jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(0))

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jbatch["images"], jbatch["pos_masks"], jbatch["person_valid"],
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return j_compute_losses(out, jbatch, m["LOSS_WEIGHTS"], True)[0]

    jgrads = _leaves(jax.jit(jax.grad(j_loss))(variables["params"]))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(params_from_jax(variables, name), strict=True)
    frozen = freeze(cfg, model)
    assert frozen
    for encoder in model.encoders():
        encoder.dropout_rate = 0.0
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    trainable = [p for p in model.parameters() if p.requires_grad]
    state = TrainState(model, *make_optimizer(cfg, trainable, steps_per_epoch=1))
    step = make_train_step(state, m["LOSS_WEIGHTS"], cfg["LOSS"]["USE_TARGET_WEIGHT"])
    metrics = step({k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()},
                   torch.Generator().manual_seed(0))
    want_keys = {"loss", "acc", "loss_multi"} | (
        {"loss_single"} if "loss_single" in jmetrics else set())
    assert set(metrics) == want_keys
    for k in want_keys - {"acc"}:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-5, err_msg=k)

    params = dict(model.named_parameters())
    for k in frozen:  # bit-equal, and no gradient
        assert torch.equal(params[k].detach(), before[k]) and params[k].grad is None, k
    grad_sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    for k, p in params.items():
        grad_sd[k] = np.zeros(p.shape, np.float64) if p.grad is None else p.grad.double().numpy()
    g_port = _leaves(convert_state_dict(grad_sd, name)[0]["params"])
    frozen_tree = _leaves(jax.tree_util.tree_map_with_path(
        lambda p, x: float(pred(p)), variables["params"]))
    old = _leaves(variables["params"])
    new_port = _leaves(convert_state_dict({k: v.detach().numpy() for k, v in
                                           model.state_dict().items()}, name)[0]["params"])
    new_jax = _leaves(new_jstate.params)
    lr = cfg["TRAIN"]["LR"]  # the schedule's rate at step 0
    for leaf, r in jgrads.items():
        if frozen_tree[leaf]:
            np.testing.assert_array_equal(new_jax[leaf], old[leaf], err_msg=leaf)
            np.testing.assert_array_equal(new_port[leaf], old[leaf], err_msg=leaf)
            continue
        atol = _grad_atol(leaf, r, jgrads)
        np.testing.assert_allclose(g_port[leaf], r, rtol=1e-3, atol=atol, err_msg=f"grad {leaf}")
        d, resolved = np.abs(new_port[leaf] - new_jax[leaf]), np.abs(r) > max(1e-3, atol)
        assert d[resolved].max(initial=0.0) < 3e-5 + 1e-3 * np.abs(
            new_jax[leaf][resolved]).max(initial=0.0), leaf
        assert d.max() < 2.2 * lr, leaf
    stats_port = _leaves(convert_state_dict({k: v.numpy() for k, v in model.state_dict().items()},
                                            name)[0]["batch_stats"])
    for leaf, r in _leaves(new_jstate.batch_stats).items():
        np.testing.assert_allclose(stats_port[leaf], r, rtol=1e-4, atol=1e-6, err_msg=leaf)
    return _leaves(variables["batch_stats"]), stats_port


@pytest.fixture
def xla_dropout_zero(monkeypatch):
    """Rate 0 in the unfused encoder's attention-weight dropout, besides the
    sites ``jax_dropout_zero`` sets."""
    xla = jatt.masked_mhsa_xla
    monkeypatch.setattr(jatt, "masked_mhsa_xla",
                        lambda q, k, v, h, mask=None, dropout_rate=0.0, dropout_rng=None:
                        xla(q, k, v, h, mask))


@pytest.mark.parametrize("eval_mode", [False, True], ids=["train_mode", "eval_mode"])
def test_singleformer_fix_step_matches_jax(jax_dropout_zero, xla_dropout_zero,  # noqa: F811
                                           eval_mode):
    jcfg = tph_jax_cfg(SINGLEFORMER_FIX=True)
    jcfg.TPU.USE_PALLAS_ATTENTION = False
    jcfg.TPU.FROZEN_STAGE_EVAL_MODE = eval_mode
    jmodel = get_model_builder(jcfg.MODEL.NAME)(jcfg, use_pallas=False)
    variables = random_variables(jmodel, jcfg, seed=31)
    cfg = presets.from_config(jcfg)
    raw = synthetic_raw_batch(cfg, [2, 1], np.random.RandomState(5), n_max=2, raw_hw=(96, 128))
    old_stats, new_stats = frozen_step(jcfg, jmodel, variables, raw)
    first = [k for k in old_stats if k.startswith("['singleformer']")]
    moved = [k for k in first if not np.array_equal(old_stats[k], new_stats[k])]
    # the frozen stage's BN statistics move in training mode, not in eval mode
    assert (moved == []) == eval_mode and first


def test_backbone_fix_step_matches_jax(jax_dropout_zero, xla_dropout_zero):  # noqa: F811
    jcfg, jmodel = tiny_jax_model(use_pallas=False)
    jcfg.TPU.USE_PALLAS_ATTENTION = False
    jcfg.MODEL.BACKBONE_FIX = True
    variables = random_variables(jmodel, jcfg, seed=3)
    raw = synthetic_raw_batch(presets.from_config(jcfg), [3, 2], np.random.RandomState(5),
                              n_max=3, raw_hw=(96, 128))
    frozen_step(jcfg, jmodel, variables, raw)
