"""The port's config reader against PyYAML and the JAX config.

* ``config/yaml_lite.py`` gives what ``yaml.safe_load`` gives on every
  recipe under ``experiments/`` and on the edge cases of the subset (the
  YAML 1.1 float rule: ``5e-4`` stays a string, ``1.0e-05`` is a float;
  ``''``, ``~``, flow collections, comments, YAML 1.1 booleans and ints),
  compared by ``repr`` (types and values); what lies outside the subset
  raises naming the file and line.
* ``config.load_config`` gives the tree the JAX ``load_config`` gives
  (``to_dict``), exactly, for all ten recipes with and without overrides
  and directories; ``to_port`` of it, and ``presets.from_config`` of the
  JAX config, equal ``torch_fixture.jax_port_config`` (the JAX config read
  by attribute, with key lists of its own); an unknown override key raises
  ``KeyError`` in both.
* The presets equal ``to_port`` of their recipes but for the differences
  their docstrings state.
* ``i2rnet_tpu_torch/config/expected_recipes.json`` (what the card holds
  the reader to) regenerates byte for byte from the JAX reader.
"""

import sys
from pathlib import Path

import pytest
import yaml

from i2rnet_tpu.config import load_config as jax_load_config
from i2rnet_tpu_torch import presets
from i2rnet_tpu_torch.config import yaml_lite
from i2rnet_tpu_torch.config.config import (default_config, load_config, merge_from_list,
                                            plain, to_port)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
import torch_fixture  # noqa: E402
RECIPES = sorted(str(p.relative_to(REPO)) for p in (REPO / "experiments").glob("*/*.yaml"))


def test_ten_recipes():
    assert len(RECIPES) == 10


@pytest.mark.parametrize("recipe", RECIPES)
def test_yaml_lite_equals_safe_load_on_the_recipes(recipe):
    text = (REPO / recipe).read_text()
    assert repr(yaml_lite.load(text, recipe)) == repr(yaml.safe_load(text))


EDGE_CASES = {
    "float rule": "a: 5e-4\nb: 1e-5\nc: 1.0e-05\nd: 0.0001\ne: 1.e-3\nf: 1e+5\ng: 3.\nh: .5\n"
                  "i: -.5\nj: -2.5E+3\nk: 00.5\n",
    "empty and null": "a: ''\nb: ~\nc:\nd: null\ne: \"\"\nf: NULL\n",
    "flow": "a: [16, 12]\nb: []\nc: {}\nd: [a, 'b, c', [1, {x: 2}]]\ne: {k: [1, 2], m: ~}\n",
    "comments": "# head\na: 1 # trailing\nb: 'x # y'\nc: a#b\n  # indented comment\nd: [1, 2] # c\n",
    "yaml 1.1 scalars": "a: yes\nb: Off\nc: 0x\nd: 08\ne: 1:3a\nf: +1\ng: -0\nh: 0b2\n"
                        "i: True\nj: _1\nk: .inf.\nl: 2001-12-14x\n",
    "quoted": "a: 'it''s'\nb: \"a \\\" b \\\\ c\"\nc: '5e-4'\nd: \"1.0\"\ne: '0x1f'\n",
    "blocks": "a:\n- 1\n- - 2\n  - 3\n- b: 4\n  c: [5]\n-\nk:\n  - x\n  - y: z\nm:\n  n:\n    o: p\n",
    "empty document": "# nothing\n",
    "top-level sequence": "- 1\n- two\n",
}


@pytest.mark.parametrize("case", list(EDGE_CASES))
def test_yaml_lite_edge_cases(case):
    text = EDGE_CASES[case]
    assert repr(yaml_lite.load(text)) == repr(yaml.safe_load(text))


def test_the_float_rule():
    got = yaml_lite.load(EDGE_CASES["float rule"])
    assert (got["a"], got["b"]) == ("5e-4", "1e-5")
    assert isinstance(got["c"], float) and got["c"] == 1e-5 and got["d"] == 1e-4


OUTSIDE = {
    "anchor": ("a: &x 1\n", 1), "alias": ("a: 1\nb: *x\n", 2), "tag": ("a: !!int 1\n", 1),
    "block scalar": ("a: |\n  x\n", 1), "folded scalar": ("a: >\n  x\n", 1),
    "multi-line plain": ("a: b\n  c\n", 2), "duplicate key": ("a: 1\na: 2\n", 2),
    "timestamp": ("a: 2001-12-14\n", 1), "document marker": ("---\na: 1\n", 1),
    "directive": ("%YAML 1.1\na: 1\n", 1), "merge key": ("b: 1\n<<: {a: 1}\n", 2),
    "tab indent": ("a:\n\t- 1\n", 2), "multi-line flow": ("a: [1,\n 2]\n", 1),
    "open quote": ("a: 'x\n", 1), "bad indent": ("a: 1\n  b: 2\n", 2),
    "hex int": ("a: 1\nb: 0x1f\n", 2), "octal int": ("a: 017\n", 1),
    "binary int": ("a: [0b101]\n", 1), "sexagesimal int": ("a: 1:30\n", 1),
    "sexagesimal float": ("a: 12:30:45.5\n", 1), "int with _": ("a: 1_000\n", 1),
    "float with _": ("a: 1_000.5\n", 1), "inf": ("a: -.inf\n", 1), "nan": ("a: .NaN\n", 1),
    "escape": ("a: \"t\\tab\"\n", 1),
}


@pytest.mark.parametrize("case", list(OUTSIDE))
def test_outside_the_subset_raises_with_file_and_line(case):
    text, line = OUTSIDE[case]
    with pytest.raises(yaml_lite.YamlLiteError, match=rf"^recipe\.yaml:{line}: "):
        yaml_lite.load(text, "recipe.yaml")


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("overrides", [False, True], ids=["plain", "overrides"])
def test_load_config_equals_jax(recipe, overrides):
    kw = {}
    if overrides:
        kw = dict(opts=["TRAIN.LR", "5e-4", "MODEL.EXTRA.NEW_KEY", "3", "GPUS", "[0, 1]",
                        "TPU.FUSED_BLOCK_TRAIN", "True", "MODEL.SINGLEFORMER", "no",
                        "DATASET.ROOT", "fixtures/x"],
                  data_dir="/data", model_dir="out", log_dir="logs")
    want = jax_load_config(recipe, **kw)
    got = load_config(recipe, **kw)
    assert repr(got) == repr(want.to_dict())
    ref = torch_fixture.jax_port_config(want)
    assert to_port(got) == ref
    assert repr(to_port(got)) == repr(ref)
    assert repr(presets.from_config(want)) == repr(ref)
    if overrides:
        assert got["TRAIN"]["LR"] == 5e-4 and got["GPUS"] == (0, 1)
        assert got["MODEL"]["SINGLEFORMER"] == "no"  # literal_eval, not YAML, reads overrides
        assert got["DATASET"]["ROOT"] == "/data/fixtures/x"
        assert to_port(got)["DEVICE"]["FUSED_BLOCK_TRAIN"] is True


def test_a_string_over_a_typed_default_is_a_literal(tmp_path):
    """yacs's ``literal_eval`` of YAML strings over typed defaults, as JAX."""
    path = tmp_path / "r.yaml"
    path.write_text("TRAIN:\n  LR: 5e-4\n  LR_END: '1e-5'\nGPUS: (0,)\nDATASET:\n  ROOT: 5e-4\n"
                    "MODEL:\n  EXTRA:\n    FOO: '[1, 2]'\n    BLOCK: BASIC\n")
    got = load_config(str(path))
    assert repr(got) == repr(jax_load_config(str(path)).to_dict())
    assert (got["TRAIN"]["LR"], got["TRAIN"]["LR_END"], got["GPUS"]) == (5e-4, 1e-5, (0,))
    assert got["DATASET"]["ROOT"] == "5e-4"  # the default is a string
    assert got["MODEL"]["EXTRA"] == {"FOO": [1, 2], "BLOCK": "BASIC"}


@pytest.mark.parametrize("key", ["TRAIN.LRR", "NOPE.X", "MODEL.NOPE"])
def test_an_unknown_override_key_raises_in_both(key):
    recipe = RECIPES[0]
    with pytest.raises(KeyError, match="Non-existent config key") as got:
        load_config(recipe, opts=[key, "1"])
    with pytest.raises(KeyError) as want:
        jax_load_config(recipe, opts=[key, "1"])
    assert str(got.value) == str(want.value)
    cfg = default_config()
    merge_from_list(cfg, ["MODEL.EXTRA.NEW", "2"])  # a new key of MODEL.EXTRA is taken
    assert cfg["MODEL"]["EXTRA"] == {"NEW": 2}
    with pytest.raises(KeyError):  # but not a new subtree, as in JAX
        merge_from_list(cfg, ["MODEL.EXTRA.STAGE9.NUM", "2"])
    with pytest.raises(KeyError):
        jax_load_config(recipe, opts=["MODEL.EXTRA.STAGE9.NUM", "2"])


#: each preset, its recipe, and the differences its docstring states
PRESETS = {
    "w48 coco": (lambda: presets.w48_pure_en6("coco"),
                 "experiments/coco/interformer_coco_w48_pure_en6.yaml", {}),
    "w48 crowdpose": (lambda: presets.w48_pure_en6("crowdpose"),
                      "experiments/crowdpose/interformer_crowdpose_w48_pure_en6.yaml", {}),
    "w48 OCHuman": (lambda: presets.w48_pure_en6("OCHuman"),
                    "experiments/OCHuman/interformer_ochuman_w48_pure_en6.yaml", {}),
    "hrt 256x192": (presets.hrt_interformer, "experiments/coco/interformer_coco_hrt_192_p2_b12.yaml",
                    {"DEVICE.FUSED_BLOCK_TRAIN": (True, False)}),
    "hrt 384x288": (lambda: presets.hrt_interformer((288, 384)),
                    "experiments/coco/interformer_coco_hrt_288_p2_b4.yaml",
                    {"DEVICE.FUSED_BLOCK_TRAIN": (True, False),
                     "MODEL.TRANS_SIZE": ([24, 18], [9, 12])}),
    "tph": (presets.tph_interformer, "experiments/coco/interformer_coco_tph_192_p4_b4.yaml", {}),
}


def _diff(preset, recipe, path=""):
    out = {}
    for k, v in preset.items():
        if isinstance(v, dict) and k != "EXTRA":
            out.update(_diff(v, recipe[k], f"{path}{k}."))
        elif k == "EXTRA":
            for ek, ev in v.items():
                if recipe[k][ek] != ev:
                    out[f"{path}EXTRA.{ek}"] = (ev, recipe[k][ek])
        elif recipe[k] != v:
            out[path + k] = (v, recipe[k])
    return out


@pytest.mark.parametrize("name", list(PRESETS))
def test_presets_equal_their_recipes(name):
    """Every key a preset sets as ``to_port(load_config(recipe))`` has it,
    but the stated differences: ``FUSED_BLOCK_TRAIN`` on in the HRT preset
    (off in every recipe), and the 384x288 ``TRANS_SIZE`` (24, 18) for the
    YAML's [9, 12], which pool alike (``test_trans_size_288_builds_the_same
    _model``). The keys the presets leave out are not compared."""
    make, recipe, stated = PRESETS[name]
    assert _diff(make(), to_port(load_config(str(REPO / recipe)))) == stated


def test_trans_size_288_builds_the_same_model():
    """The model built from the 384x288 YAML (``TRANS_SIZE`` [9, 12]) is the
    model of the preset (24, 18): the same state dict, and the same token
    grid as the JAX builder makes of the YAML (shapes only)."""
    import jax
    import numpy as np

    from i2rnet_tpu.registry import get_model_builder
    from i2rnet_tpu_torch.convert.jax_import import params_from_jax
    from i2rnet_tpu_torch.models.interformer import build_model

    recipe = "experiments/coco/interformer_coco_hrt_288_p2_b4.yaml"
    from_yaml = build_model(to_port(load_config(recipe)), device="cpu")
    preset = build_model(presets.hrt_interformer((288, 384)), device="cpu")
    a, b = from_yaml.state_dict(), preset.state_dict()
    assert {k: tuple(v.shape) for k, v in a.items()} == {k: tuple(v.shape) for k, v in b.items()}
    jcfg = jax_load_config(recipe)
    jmodel = get_model_builder(jcfg.MODEL.NAME)(jcfg, use_pallas=True)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), np.zeros((1, 1, 384, 288, 3), np.float32),
        np.zeros((1, 1, 384, 288, 1), np.float32), np.ones((1, 1), bool), train=False))
    sd = params_from_jax(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes),
                         "interformer")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in a.items() if k in sd}
    assert set(sd) == set(a)


def test_expected_recipes_regenerate():
    assert torch_fixture.expected_recipes() == torch_fixture.RECIPES_JSON.read_text()


def test_plain_makes_lists_and_dicts():
    assert plain({"a": (1, (2, 3)), "b": {"c": [4]}}) == {"a": [1, [2, 3]], "b": {"c": [4]}}
