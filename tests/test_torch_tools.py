"""The port's entry points, ``tools/train.py`` and ``tools/test.py``, on the CPU.

From a tiny recipe YAML written into ``tmp_path`` (the tiny W48 model over
the committed COCO fixture, ``WORKERS`` 0, float32):

* ``tools.train.main`` then ``tools.test.main`` (``--device cpu``) give the
  losses and AP that ``core.trainer.train_loop`` and ``core.validate.
  validate`` give when called directly on the same config, exactly (one
  process, the same seeds);
* the output and log layout is the JAX ``create_logger``'s:
  ``OUTPUT_DIR/{dataset}/{model}/{cfg_name}`` and
  ``LOG_DIR/{dataset}/{model}/GT_{USE_GT_BBOX}_{phase}_{cfg_name}_*.log``;
* ``test`` takes ``TEST.MODEL_FILE`` (a port checkpoint) where it is set,
  and raises for a file that is not there; the data-parallel flags raise
  where they cannot start a process group;
* ``metric_table`` is the JAX one's text.
"""

import logging
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.config.config import load_config, to_port
from i2rnet_tpu_torch.core.trainer import train_loop
from i2rnet_tpu_torch.core.validate import validate
from i2rnet_tpu_torch.data.coco import COCODataset
from i2rnet_tpu_torch.models.interformer import build_model
from i2rnet_tpu_torch.tools import test as test_tool
from i2rnet_tpu_torch.tools import train as train_tool
from i2rnet_tpu_torch.utils.logging import metric_table
from torch_fixture import FIXTURE

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]


def write_recipe(path: Path) -> Path:
    """A recipe YAML of the tiny W48 model on the COCO fixture."""
    m = presets.tiny_test_config(17)["MODEL"]
    recipe = {
        "MODEL": {**m, "NAME": "interformer_pureMulti"},
        "DATASET": {"DATASET": "coco", "ROOT": str(FIXTURE), "TRAIN_SET": "train2017",
                    "TEST_SET": "val2017", "MAX_PATCH": 2, "COLOR_RGB": True},
        "TRAIN": {"BATCH_SIZE_PER_GPU": 2, "END_EPOCH": 2, "LR": 0.001},
        "TEST": {"BATCH_SIZE_PER_GPU": 8, "FLIP_TEST": True, "BLUR_KERNEL": 5,
                 "POST_PROCESS": True, "USE_GT_BBOX": True},
        "TPU": {"COMPUTE_DTYPE": "float32", "USE_PALLAS_ATTENTION": False},
        "WORKERS": 0, "PRINT_FREQ": 1, "AUTO_RESUME": False,
    }
    path.write_text(yaml.safe_dump(recipe))
    return path


@pytest.fixture
def recipe(tmp_path):
    yield write_recipe(tmp_path / "tiny_w48.yaml")
    logger = logging.getLogger("i2rnet_tpu_torch")  # create_logger's handlers
    for handler in logger.handlers:
        handler.close()
    logger.handlers.clear()


def _dirs(tmp_path):
    return ["--modelDir", str(tmp_path / "out"), "--logDir", str(tmp_path / "log")]


@pytest.fixture
def trained(recipe, tmp_path):
    """train.main for one epoch of two steps, then test.main: (their
    losses, the test's (name_value, perf), output dir)."""
    losses = []
    state, out = train_tool.main(
        ["--cfg", str(recipe), *_dirs(tmp_path), "--max-epochs", "1",
         "--max-steps-per-epoch", "2", "--device", "cpu"],
        on_step=lambda e, i, m: losses.append(float(m["loss"])))
    result = test_tool.main(["--cfg", str(recipe), *_dirs(tmp_path), "--device", "cpu"])
    return losses, result, out, state


def test_train_then_test_equal_the_loop_and_validate(trained, recipe, tmp_path):
    losses, (name_value, perf), out, state = trained
    cfg = to_port(load_config(str(recipe)))
    direct = []
    direct_state = train_loop(cfg, str(tmp_path / "direct"), max_epochs=1, max_steps_per_epoch=2,
                              device="cpu",
                              on_step=lambda e, i, m: direct.append(float(m["loss"])))
    assert len(losses) == 2 and losses == direct
    for k, v in direct_state.model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(Path(out) / "final_state.pth")["state_dict"])
    ds = COCODataset(cfg, cfg["DATASET"]["ROOT"], "val2017", is_train=False)
    want, want_perf = validate(cfg, ds, model, str(tmp_path / "direct_val"), device="cpu")
    assert dict(name_value) == dict(want) and perf == want_perf
    assert np.isfinite(perf)


def test_the_layout_is_create_loggers(trained, recipe, tmp_path):
    """The port's directories and log names as the JAX ``create_logger``
    makes them from the same YAML and flags."""
    import os

    from i2rnet_tpu.config import load_config as jax_load_config
    from i2rnet_tpu.utils.logging import create_logger as jax_create_logger

    _, _, out, _ = trained
    jcfg = jax_load_config(str(recipe), model_dir=str(tmp_path / "jax_out"),
                           log_dir=str(tmp_path / "jax_log"))
    _, jax_out, jax_tb = jax_create_logger(jcfg, str(recipe), "train")
    logging.getLogger("i2rnet_tpu").handlers.clear()
    assert (Path(out).relative_to(tmp_path / "out")
            == Path(jax_out).relative_to(tmp_path / "jax_out")
            == Path("coco/interformer_pureMulti/tiny_w48"))
    logs = sorted(p.name for p in (tmp_path / "log" / "coco" / "interformer_pureMulti").glob(
        "*.log"))
    jax_logs = sorted(p.name for p in (tmp_path / "jax_log" / "coco" /
                                       "interformer_pureMulti").glob("*.log"))
    assert [n.rsplit("_", 1)[0] for n in jax_logs] == ["GT_True_train_tiny_w48"]
    assert {n.rsplit("_", 1)[0] for n in logs} == {"GT_True_train_tiny_w48",
                                                   "GT_True_valid_tiny_w48"}
    assert all(os.path.getsize(tmp_path / "log" / "coco" / "interformer_pureMulti" / n) > 0
               for n in logs)
    for name in ("final_state.pth", "model_best.pth", "checkpoint/epoch_0.pth",
                 "results/keypoints_val2017_results.json"):
        assert (Path(out) / name).is_file(), name


def test_test_takes_the_model_file(trained, recipe, tmp_path):
    """``TEST.MODEL_FILE``: an epoch checkpoint of the port, through the
    trailing overrides, gives the final state's metrics (one epoch: the same
    weights); a file that is not there raises."""
    _, (name_value, _), out, _ = trained
    epoch = str(Path(out) / "checkpoint" / "epoch_0.pth")
    got, _ = test_tool.main(["--cfg", str(recipe), *_dirs(tmp_path), "--device", "cpu",
                             "--max-batches", "10", "TEST.MODEL_FILE", epoch])
    assert dict(got) == dict(name_value)
    with pytest.raises(FileNotFoundError):
        test_tool.main(["--cfg", str(recipe), *_dirs(tmp_path), "--device", "cpu",
                        "TEST.MODEL_FILE", str(tmp_path / "none.pth")])


@pytest.mark.parametrize("flag", [["--coordinator", "localhost:1234", "--backend", "nccl"],
                                  ["--num-processes", "2"], ["--process-id", "1"]])
def test_multi_host_flags_raise(recipe, tmp_path, flag):
    """The data-parallel flags raise where they cannot start a group: ``nccl``
    for the CPU (no quiet ``gloo``), and a world or rank without a
    coordinator (``tests/test_torch_ddp.py`` runs the group)."""
    with pytest.raises((ValueError, RuntimeError), match="nccl|coordinator"):
        train_tool.main(["--cfg", str(recipe), *_dirs(tmp_path), "--device", "cpu", *flag])


def test_seed_and_an_unknown_override(recipe, tmp_path):
    args = train_tool.parse_args(["--cfg", str(recipe), "--seed", "4", "TRAIN.LR", "5e-4"])
    cfg = train_tool.load_cfg(args)
    assert (args.seed, cfg["TRAIN"]["LR"], cfg["MODEL"]["NAME"]) == (4, 5e-4,
                                                                      "interformer_pureMulti")
    with pytest.raises(KeyError, match="TRAIN.NOPE"):
        train_tool.main(["--cfg", str(recipe), "--device", "cpu", "TRAIN.NOPE", "1"])


def test_metric_table_is_the_jax_text():
    from i2rnet_tpu.utils.logging import metric_table as jax_metric_table

    values = {"AP": 0.123456, "Ap .5": np.float64(0.5), "AR": 1, "Mean@0.1": 99.0}
    assert metric_table(values, "interformer") == jax_metric_table(values, "interformer")


def test_the_entry_points_run_as_modules(recipe, tmp_path):
    """``python3 -m i2rnet_tpu_torch.tools.test --help`` from the repository."""
    import subprocess

    for tool in ("train", "test"):
        proc = subprocess.run([sys.executable, "-m", f"i2rnet_tpu_torch.tools.{tool}", "--help"],
                              cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0 and "--device" in proc.stdout, proc.stderr


def test_model_builders_by_name():
    """``registry.get_model_builder``: the ported names, each building the
    model of the config; an unknown name raises as JAX's does."""
    from i2rnet_tpu.registry import get_model_builder as jax_builder
    from i2rnet_tpu_torch.models.interformer import InterFormer
    from i2rnet_tpu_torch.models.pure_multi import PureMultiInterFormer
    from i2rnet_tpu_torch.registry import get_model_builder

    for name, cfg, cls in (("interformer_pureMulti", presets.tiny_test_config(5),
                            PureMultiInterFormer),
                           ("interformer", presets.tiny_hrt_config(5), InterFormer),
                           ("interformer_2stage", presets.tiny_tph_config(5), InterFormer)):
        jax_builder(name)
        assert type(get_model_builder(name)(cfg, device="cpu")) is cls
    with pytest.raises(KeyError) as got:
        get_model_builder("interformer_e2e_typo")
    with pytest.raises(KeyError) as want:
        jax_builder("interformer_e2e_typo")
    assert str(got.value).split(";")[0] == str(want.value).split(";")[0]

