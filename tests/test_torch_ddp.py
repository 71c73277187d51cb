"""Data parallelism across processes on the CPU: two ``gloo`` ranks against JAX.

Every case starts its ranks through ``probes/ddp_rank.py::run_ranks``: fresh
processes that import only the port, a ``file://`` rendezvous in the test's
own ``tmp_path`` (so concurrent test workers never race for a port), and a
time limit per run; a rank that fails fails the test.

* The masked sync-BN (``models/layers.py::MaskedBatchNorm`` under a group):
  the two ranks' outputs, input gradients, summed weight and bias gradients
  and running statistics against the JAX ``MaskedBatchNorm`` on the global
  batch, with rank 1 holding no valid person, without a mask, and recomputed
  under ``remat`` (f32: 1e-5 relative, 1e-6 absolute).
* One Adam step of the tiny W48 model over two ranks (dropout 0) against the
  JAX ``make_train_step`` on the global batch: the global loss (rtol 1e-5)
  and accuracy, the post-step parameters (the resolved-gradient rule of
  ``test_torch_train_step.py``), the BatchNorm statistics (rtol 1e-4, atol
  1e-6), and both ranks holding the same bits; once with a rank whose images
  hold no valid person.
* A world of one is bit-equal to the undistributed step, dropout on.
* With dropout on and every rank given the same rows, the ranks' training
  forwards differ (each folds its rank into the dropout seed), and agree at
  dropout 0.
* ``validate`` over two ranks with the GT oracle on the committed COCO
  fixture gives the one-process ``name_value`` exactly, and every rank the
  same results file, in the default and ``main_target`` modes.
* ``train_loop`` over two ranks: rank 0 alone writes checkpoints, and both
  end with the same weights and the same (global) losses; over a whole
  epoch whose two shards hold different numbers of batches, both ranks take
  the fewest.
* ``nccl`` without CUDA raises, and a rank that fails fails the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from i2rnet_tpu.core.train import make_train_step as j_make_train_step
from i2rnet_tpu.core.train_state import create_train_state, make_optimizer as j_make_optimizer
from i2rnet_tpu.models.layers import MaskedBatchNorm as JaxMaskedBatchNorm
from i2rnet_tpu.ops.preprocess import device_preprocess as j_device_preprocess
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.core.train import make_train_step, rank_seed
from i2rnet_tpu_torch.core.train_state import TrainState, make_optimizer
from i2rnet_tpu_torch.core.trainer import epoch_plan
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.data.synthetic import synthetic_raw_batch
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.models.pure_multi import init_weights
from i2rnet_tpu_torch.parallel import dist
from i2rnet_tpu_torch.probes.ddp_rank import run_ranks
from test_torch_bridge import port_model, random_variables, tiny_jax_model
from test_torch_train_step import _grad_noise, _leaves, _tree, jax_dropout_zero  # noqa: F401
from torch_fixture import FIXTURE

torch.set_num_threads(2)

RANK_TIMEOUT = 240.0


def jax_bn(x, mask, cot, weight, bias):
    """The JAX BN on the global NCHW batch: (y, dx, dscale, dbias, stats)."""
    bn = JaxMaskedBatchNorm()
    xh = jnp.asarray(x.numpy().transpose(0, 2, 3, 1))
    c = x.shape[1]
    variables = {"params": {"scale": jnp.asarray(weight.numpy()), "bias": jnp.asarray(bias.numpy())},
                 "batch_stats": {"mean": jnp.zeros(c), "var": jnp.ones(c)}}
    m = None if mask is None else jnp.asarray(mask.numpy())

    def run(xv, params):
        y, upd = bn.apply({"params": params, "batch_stats": variables["batch_stats"]}, xv, m,
                          train=True, mutable=["batch_stats"])
        return y, upd["batch_stats"]

    y, stats = run(xh, variables["params"])
    _, vjp = jax.vjp(lambda xv, p: run(xv, p)[0], xh, variables["params"])
    dx, dp = vjp(jnp.asarray(cot.numpy().transpose(0, 2, 3, 1)))
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return (to_nchw(y), to_nchw(dx), np.asarray(dp["scale"]), np.asarray(dp["bias"]),
            {k: np.asarray(v) for k, v in stats.items()})


@pytest.mark.parametrize("case", ["rank1_empty", "no_mask", "remat"])
def test_sync_bn_matches_jax_on_the_global_batch(tmp_path, case):
    g = torch.Generator().manual_seed(3)
    b, c, h, w = 4, 6, 5, 4
    x = torch.randn(b, c, h, w, generator=g) * 2 + 0.5
    cot = torch.randn(b, c, h, w, generator=g)
    mask = {"rank1_empty": torch.tensor([True, False, False, False]), "no_mask": None,
            "remat": torch.tensor([True, True, False, True])}[case]
    weight, bias = torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g)
    job = {"x": x, "cot": cot, "mask": mask, "weight": weight, "bias": bias,
           "remat": case == "remat"}
    ranks = run_ranks("bn", job, 2, tmp_path, device="cpu", timeout=RANK_TIMEOUT)
    y, dx, dw, db, stats = jax_bn(x, mask, cot, weight, bias)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([r["y"] for r in ranks]).numpy(), y, **tol)
    np.testing.assert_allclose(torch.cat([r["dx"] for r in ranks]).numpy(), dx, **tol)
    for r in ranks:
        np.testing.assert_allclose(r["dw"].numpy(), dw, **tol)
        np.testing.assert_allclose(r["db"].numpy(), db, **tol)
        np.testing.assert_allclose(r["running_mean"].numpy(), stats["mean"], **tol)
        np.testing.assert_allclose(r["running_var"].numpy(), stats["var"], **tol)
        assert int(r["num_batches_tracked"]) == 1  # the recomputation moved nothing
    for k in ("running_mean", "running_var", "dw", "db"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k


def _step_job(cfg, model, batch, dropout, rows="split"):
    return {"cfg": cfg, "state_dict": {k: v.clone() for k, v in model.state_dict().items()},
            "batch": batch, "dropout": dropout, "rows": rows}


@pytest.mark.parametrize("counts", [(3, 2, 1, 2), (3, 2, 0, 0)])
def test_two_rank_step_matches_jax(tmp_path, jax_dropout_zero, counts):
    jcfg, jmodel = tiny_jax_model(use_pallas=True)  # its training kernels at rate 0
    variables = random_variables(jmodel, jcfg, seed=3)
    cfg = presets.from_config(jcfg)
    m = cfg["MODEL"]
    raw = synthetic_raw_batch(cfg, list(counts), np.random.RandomState(5), n_max=3,
                              raw_hw=(96, 128))
    jbatch = j_device_preprocess(raw, tuple(m["IMAGE_SIZE"]), tuple(m["HEATMAP_SIZE"]),
                                 m["SIGMA"])
    tx, jsched = j_make_optimizer(jcfg, steps_per_epoch=1)
    jstep = j_make_train_step(jmodel, tx, loss_weights=jcfg.MODEL.LOSS_WEIGHTS,
                              use_target_weight=jcfg.LOSS.USE_TARGET_WEIGHT, donate=False)
    new_jstate, jmetrics = jstep(create_train_state(jmodel, variables, tx), jbatch,
                                 jax.random.PRNGKey(0))

    from i2rnet_tpu.core.train import compute_losses as j_compute_losses

    def j_loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jbatch["images"], jbatch["pos_masks"], jbatch["person_valid"],
                              train=True, mutable=["batch_stats"],
                              rngs={"dropout": jax.random.PRNGKey(0)})
        return j_compute_losses(out, jbatch, jcfg.MODEL.LOSS_WEIGHTS, True)[0]

    jgrads = jax.jit(jax.grad(j_loss))(variables["params"])

    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    ranks = run_ranks("step", _step_job(cfg, port_model(variables, jcfg), batch, 0.0), 2,
                      tmp_path, device="cpu", timeout=RANK_TIMEOUT)
    for r in ranks:
        np.testing.assert_allclose(r["metrics"]["loss"], float(jmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["metrics"]["acc"], float(jmetrics["acc"]), atol=1e-6)
        assert r["same"]
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k

    lr = float(jsched(0))
    new = _tree({k: v.numpy() for k, v in ranks[0]["state_dict"].items()})
    for (path, a), (_, r), (_, gr) in zip(_leaves(new["params"]), _leaves(new_jstate.params),
                                          _leaves(jgrads)):
        a, r, gr = (np.asarray(x, np.float64) for x in (a, r, gr))
        name = jax.tree_util.keystr(path)
        d, resolved = np.abs(a - r), np.abs(gr) > max(1e-3, _grad_noise(name, gr))
        assert d[resolved].max(initial=0.0) < 3e-5 + 1e-3 * np.abs(r[resolved]).max(initial=0.0), name
        assert d.max() < 2.2 * lr, name
    for (path, a), (_, r) in zip(_leaves(new["batch_stats"]), _leaves(new_jstate.batch_stats)):
        np.testing.assert_allclose(a, np.asarray(r), rtol=1e-4, atol=1e-6,
                                   err_msg=f"batch_stats {jax.tree_util.keystr(path)}")


def _tiny_seeded(counts=(3, 2, 0, 1)):
    cfg = presets.tiny_test_config(5)
    m = cfg["MODEL"]
    model = build_model(cfg, device="cpu")
    init_weights(model, torch.Generator().manual_seed(0))
    from i2rnet_tpu_torch.core.trainer import raw_to_device
    from i2rnet_tpu_torch.ops.preprocess import device_preprocess

    raw = synthetic_raw_batch(cfg, list(counts), np.random.RandomState(5), n_max=3,
                              raw_hw=(96, 128))
    batch = device_preprocess(raw_to_device(raw, "cpu"), tuple(m["IMAGE_SIZE"]),
                              tuple(m["HEATMAP_SIZE"]), m["SIGMA"])
    return cfg, model, batch


def test_world_of_one_is_bit_equal_to_the_undistributed_step(tmp_path):
    cfg, model, batch = _tiny_seeded()
    job = _step_job(cfg, model, batch, 0.1)
    (one,) = run_ranks("step", job, 1, tmp_path, device="cpu", timeout=RANK_TIMEOUT)
    state = TrainState(model, *make_optimizer(cfg, list(model.parameters()), steps_per_epoch=1))
    for encoder in model.encoders():
        encoder.dropout_rate = 0.1
    step = make_train_step(state, cfg["MODEL"]["LOSS_WEIGHTS"], cfg["LOSS"]["USE_TARGET_WEIGHT"])
    metrics = step(batch, torch.Generator().manual_seed(0))
    assert one["metrics"] == {k: float(v) for k, v in metrics.items()}
    for k, v in model.state_dict().items():
        assert torch.equal(one["state_dict"][k], v), k


def test_ranks_draw_different_dropout_bits(tmp_path):
    """Both ranks get the whole batch: their training forwards differ only
    by the dropout bits, which the rank folds into the seed (rank 0 keeps
    the step's)."""
    cfg, model, batch = _tiny_seeded()
    on = run_ranks("step", _step_job(cfg, model, batch, 0.1, rows="all"), 2, tmp_path / "on",
                   device="cpu", timeout=RANK_TIMEOUT)
    assert not torch.equal(on[0]["multi"], on[1]["multi"])
    off = run_ranks("step", _step_job(cfg, model, batch, 0.0, rows="all"), 2, tmp_path / "off",
                    device="cpu", timeout=RANK_TIMEOUT)
    assert torch.equal(off[0]["multi"], off[1]["multi"])
    assert rank_seed(12345, 0) == 12345 and len({rank_seed(12345, r) for r in range(4)}) == 4


def fixture_cfg(**changes):
    """The tiny model over the committed COCO fixture (``coco_synth``)."""
    cfg = presets.tiny_test_config(17)
    cfg["DATASET"].update(DATASET="coco", ROOT=str(FIXTURE), TRAIN_SET="train2017",
                          TEST_SET="val2017", MAX_PATCH=2)
    cfg["TEST"].update(BATCH_SIZE_PER_GPU=3, BLUR_KERNEL=5)
    cfg.update(WORKERS=0, PRINT_FREQ=1, AUTO_RESUME=False)
    for key, v in changes.items():
        sec, k = key.split(".")
        cfg[sec][k] = v
    return cfg


@pytest.mark.parametrize("mode", ["default", "main_target"])
def test_two_rank_validate_with_the_oracle_gives_the_one_process_ap(tmp_path, mode):
    """3 rows a rank (a global batch of 6 over the fixture's 32 images: the
    last batch partial, rank 1's block of it all padding)."""
    changes = {"default": {}, "main_target": {"DATASET.PATCH_MODE": "main_target"}}[mode]
    cfg = fixture_cfg(**changes)
    job = {"cfg": cfg, "root": str(FIXTURE), "runs": [{"out": str(tmp_path / "ranks")}]}
    ranks = [r["runs"][0] for r in run_ranks("validate", job, 2, tmp_path / "run",
                                             device="cpu", timeout=RANK_TIMEOUT)]
    one = fixture_cfg(**changes, **{"TEST.BATCH_SIZE_PER_GPU": 6})
    ds = COCODataset(one, str(FIXTURE), "val2017", is_train=False)
    want, perf = validate(one, ds, None, str(tmp_path / "one"), device="cpu",
                          eval_step_fn=lambda _m, batch: batch["target"])
    results = sorted((tmp_path / "one" / "results").glob("*.json"))[0].read_bytes()
    for r in ranks:
        assert r["name_value"] == dict(want) and r["perf"] == perf
        assert r["results"] == results
    assert perf > 0.9
    assert sorted(p.name for p in (tmp_path / "ranks").iterdir()) == ["proc0", "proc1"]


def test_rank0_alone_writes_checkpoints(tmp_path):
    cfg = fixture_cfg(**{"TRAIN.BATCH_SIZE_PER_GPU": 2})
    job = {"cfg": cfg, "out": str(tmp_path / "out"), "max_epochs": 2, "max_steps": 1}
    ranks = run_ranks("train", job, 2, tmp_path / "run", device="cpu", timeout=RANK_TIMEOUT)
    assert ranks[0]["saved"] == [0, 1] and ranks[1]["saved"] == []
    assert sorted(p.name for p in (tmp_path / "out" / "checkpoint").iterdir()) == [
        "epoch_0.pth", "epoch_1.pth"]
    assert (tmp_path / "out" / "final_state.pth").exists()
    assert ranks[0]["losses"] == ranks[1]["losses"] and len(ranks[0]["losses"]) == 2
    assert all(np.isfinite(ranks[0]["losses"]))
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k


@pytest.mark.parametrize("mode", ["random", "main_target"])
def test_ranks_take_the_same_steps_over_a_whole_epoch(tmp_path, mode):
    """A whole epoch over two ranks whose shards hold different numbers of
    batches (4 images a rank: 3 and 2 batches in ``random`` mode, 13 and 11
    under ``main_target``): both take the fewest, with the same global
    losses, and end with the same weights."""
    cfg = fixture_cfg(**{"TRAIN.BATCH_SIZE_PER_GPU": 4, "DATASET.PATCH_MODE": mode})
    ds = COCODataset(cfg, str(FIXTURE), "train2017", is_train=True)
    counts = [len(epoch_plan(cfg, ds, 0, 4, r, 2)) for r in range(2)]
    assert counts[0] != counts[1]
    job = {"cfg": cfg, "out": str(tmp_path / "out"), "max_epochs": 1, "max_steps": None}
    ranks = run_ranks("train", job, 2, tmp_path / "run", device="cpu", timeout=RANK_TIMEOUT)
    assert len(ranks[0]["losses"]) == min(counts)
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["saved"] == [0] and ranks[1]["saved"] == []
    for k, v in ranks[0]["state_dict"].items():
        assert torch.equal(v, ranks[1]["state_dict"][k]), k


def test_no_quiet_fallback(tmp_path):
    """``nccl`` without CUDA raises before any group starts; a rank that
    raises fails the run (its log in the error), the other rank stopped."""
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    with pytest.raises((RuntimeError, ValueError), match="nccl"):
        dist.init(num_processes=1, process_id=0, backend="nccl", device="cpu",
                  init_method=dist.file_init_method(tmp_path / "rv"))
    assert not dist.initialized()
    with pytest.raises(RuntimeError, match="rank 0 failed|rank 1 failed"):
        run_ranks("bn", {"x": torch.zeros(3, 2, 2, 2)}, 2, tmp_path / "bad", device="cpu",
                  timeout=60)
