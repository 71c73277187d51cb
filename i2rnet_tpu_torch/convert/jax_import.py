"""JAX variable tree -> the port's state dict (the original PyTorch names).

``params_from_jax(variables, model_name)`` takes the JAX model's
``{"params": ..., "batch_stats": ...}`` tree (numpy or jax arrays; read with
``np.asarray`` only) and returns a state dict that the port's model of
``model_name`` (``interformer_pureMulti``; ``interformer`` and
``interformer_2stage``, the two-stage model with the HRFormer or the
TransPose-H first stage; ``interformer_e2e`` and ``interformer_e2e_new``)
takes with ``load_state_dict(..., strict=True)``. It
is the exact inverse of ``i2rnet_tpu/convert/torch_import.py::
convert_state_dict`` (``rewrite_interformer_2stage`` hands the main names,
``upsample_layer.deconv_layers.{i}`` and the multiplex block's
``deconv_layers.{0,1}``, on to ``rewrite_interformer``):

* names: JAX module paths -> the reference's module names;
* conv kernels HWIO -> OIHW (depthwise ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]``);
  a deconv's spatially flipped HWIO -> ``ConvTranspose2d``'s
  ``[I, O, kh, kw]``; dense ``[in, out]`` -> ``[out, in]``;
* the encoders' separate ``q_proj``/``k_proj``/``v_proj`` -> packed
  ``in_proj_weight``/``in_proj_bias`` (HRFormer's window attention keeps
  them separate, as the reference does);
* BN/LN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var`` (+ ``num_batches_tracked`` = 0); HRFormer's
  ``rpe_table`` -> ``relative_position_bias_table`` and the
  ``relative_position_index`` buffer regenerated (the JAX tree has none).

The JAX package's converter has no rule for the ``upconv`` upsampling's
names (the JAX ``upsample/...``); this function maps them to the port's
``upsample_layer.{fuse,conv1,conv2}``. Its e2e rule drops the name
``single_pos_embedding`` (the reference's sine buffer), so a learnable e2e
table (the JAX ``single_pos``) comes here but does not go back.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from i2rnet_tpu_torch.models.hrformer import _rpe_index
from i2rnet_tpu_torch.models.interformer import TWO_STAGE_NAMES
from i2rnet_tpu_torch.models.interformer_e2e import E2E_BUILDERS

_CB = {"conv": "0", "bn": "1"}
_FUSE = {"dw": "0", "dwbn": "1", "pw": "2", "pwbn": "3"}
_SF = "singleformer.backbone"
_BLK = r"singleformer/stage(\d)/m(\d+)_b(\d+)_blk(\d+)"


def _blk(m) -> str:
    return f"{_SF}.stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}"


def _trunk_rules(jax: str, port: str):
    """The HRNet trunk under JAX path ``{jax}trunk/`` and port prefix ``port``
    (the vanilla model's own names; TransPose-H's under ``singleformer.``)."""
    t = f"{jax}trunk"
    return [
        (rf"{t}/stem/conv([12])/(conv|bn)", lambda m: f"{port}{m[2]}{m[1]}"),
        (rf"{t}/stem/layer1_(\d+)/conv([123])/(conv|bn)",
         lambda m: f"{port}layer1.{m[1]}.{m[3]}{m[2]}"),
        (rf"{t}/stem/layer1_(\d+)/downsample/(conv|bn)",
         lambda m: f"{port}layer1.{m[1]}.downsample.{_CB[m[2]]}"),
        (rf"{t}/stage(\d)/transition/t(\d+)/(conv|bn)",
         lambda m: f"{port}transition{int(m[1]) - 1}.{m[2]}.{_CB[m[3]]}"),
        (rf"{t}/stage(\d)/transition/t(\d+)_(\d+)/(conv|bn)",
         lambda m: f"{port}transition{int(m[1]) - 1}.{m[2]}.{m[3]}.{_CB[m[4]]}"),
        (rf"{t}/stage(\d)/module(\d+)/branch(\d+)_block(\d+)/conv([12])/(conv|bn)",
         lambda m: f"{port}stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.{m[6]}{m[5]}"),
        (rf"{t}/stage(\d)/module(\d+)/branch(\d+)_block(\d+)/downsample/(conv|bn)",
         lambda m: f"{port}stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.downsample.{_CB[m[5]]}"),
        (rf"{t}/stage(\d)/module(\d+)/fuse(\d+)_(\d+)/(conv|bn)",
         lambda m: f"{port}stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{_CB[m[5]]}"),
        (rf"{t}/stage(\d)/module(\d+)/fuse(\d+)_(\d+)_(\d+)/(conv|bn)",
         lambda m: f"{port}stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{m[5]}.{_CB[m[6]]}"),
    ]


def _encoder_rules(jax: str, port: str):
    """A transformer encoder's layers but their packed q/k/v (``_qkv``)."""
    return [
        (rf"{jax}/layer(\d+)/self_attn/out_proj",
         lambda m: f"{port}.layers.{m[1]}.self_attn.out_proj"),
        (rf"{jax}/layer(\d+)/(linear[12]|norm[12])", lambda m: f"{port}.layers.{m[1]}.{m[2]}"),
    ]


def _qkv(jax: str, port: str):
    return re.compile(rf"{jax}/layer(\d+)/self_attn/([qkv])_proj"), port


_MP = "multi_position_embedding"
#: the HRFormer first stage
_HRFORMER = [
    (r"singleformer/conv([12])/(conv|bn)", lambda m: f"{_SF}.{m[2]}{m[1]}"),
    (r"singleformer/layer1_(\d+)/conv([123])/(conv|bn)",
     lambda m: f"{_SF}.layer1.{m[1]}.{m[3]}{m[2]}"),
    (r"singleformer/layer1_(\d+)/downsample/(conv|bn)",
     lambda m: f"{_SF}.layer1.{m[1]}.downsample.{_CB[m[2]]}"),
    (r"singleformer/stage(\d)/transition(\d+)/(conv|bn)",
     lambda m: f"{_SF}.transition{int(m[1]) - 1}.{m[2]}.{_CB[m[3]]}"),
    (r"singleformer/stage(\d)/transition(\d+)_(\d+)/(conv|bn)",
     lambda m: f"{_SF}.transition{int(m[1]) - 1}.{m[2]}.{m[3]}.{_CB[m[4]]}"),
    (_BLK + r"/(norm[12])", lambda m: f"{_blk(m)}.{m[5]}"),
    (_BLK + r"/attn", lambda m: f"{_blk(m)}.attn.attn"),
    (_BLK + r"/attn/([qkv]|out)_proj", lambda m: f"{_blk(m)}.attn.attn.{m[5]}_proj"),
    (_BLK + r"/mlp/(fc[12]|dw3x3|norm[123])", lambda m: f"{_blk(m)}.mlp.{m[5]}"),
    (r"singleformer/stage(\d)/m(\d+)_fuse/fuse(\d+)_(\d+)/(conv|bn)",
     lambda m: f"{_SF}.stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{_CB[m[5]]}"),
    (r"singleformer/stage(\d)/m(\d+)_fuse/fuse(\d+)_(\d+)_(\d+)_(dw|dwbn|pw|pwbn)",
     lambda m: f"{_SF}.stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{m[5]}.{_FUSE[m[6]]}"),
    (r"singleformer/final_layer", lambda m: "singleformer.keypoint_head.final_layer"),
]
#: the TransPose-H first stage
_TRANSPOSE_H = _trunk_rules("singleformer/", "singleformer.") + _encoder_rules(
    "singleformer/global_encoder", "singleformer.global_encoder") + [
    (r"singleformer/(reduce|final_layer)", lambda m: f"singleformer.{m[1]}"),
]
#: the two-stage model after its first stage
_TWO_STAGE = _encoder_rules("multi_encoder", "multi_global_encoder") + [
    (r"multi_pos/conv([12])/(conv|bn)", lambda m: f"{_MP}.{m[2]}{m[1]}"),
    (r"multi_pos/conv_(pre|end)", lambda m: f"{_MP}.conv_{m[1]}"),
    (r"multi_pos/res_conv1", lambda m: f"{_MP}.res.0"),
    (r"multi_pos/res_bn1", lambda m: f"{_MP}.res.1"),
    (r"multi_pos/res_layer1_(\d)/conv([12])/(conv|bn)", lambda m: f"{_MP}.res.4.{m[1]}.{m[3]}{m[2]}"),
    (r"deconv(\d+)", lambda m: f"upsample_layer.deconv_layers.{m[1]}.0"),
    (r"deconv(\d+)/bn", lambda m: f"upsample_layer.deconv_layers.{m[1]}.1"),
    (r"deconv", lambda m: "deconv_layers.0"),  # multiplex: one block, applied each step
    (r"deconv/bn", lambda m: "deconv_layers.1"),
    (r"upsample/(fuse|conv[12])/(conv|bn)", lambda m: f"upsample_layer.{m[1]}.{_CB[m[2]]}"),
    (r"(domain_trans_[12]|final_layer)", lambda m: m[1]),
]
# JAX module path -> torch module name, and the encoders whose q/k/v the port
# packs into in_proj, per model (the two-stage model's per first stage)
_RULES = {
    "interformer_pureMulti": (_trunk_rules("", "") + _encoder_rules("encoder", "global_encoder") + [
        (r"reduce", lambda m: "reduce"),
        (r"multi_pos/conv([12])/(conv|bn)", lambda m: f"position_embedding.{m[2]}{m[1]}"),
        (r"deconv", lambda m: "deconv_layers.0"),
        (r"deconv/bn", lambda m: "deconv_layers.1"),
        (r"final_layer", lambda m: "final_layer"),
    ], [_qkv("encoder", "global_encoder")]),
    "hrformer": (_HRFORMER + _TWO_STAGE, [_qkv("multi_encoder", "multi_global_encoder")]),
    "transpose_h": (_TRANSPOSE_H + _TWO_STAGE,
                    [_qkv("singleformer/global_encoder", "singleformer.global_encoder"),
                     _qkv("multi_encoder", "multi_global_encoder")]),
    # the end-to-end models: the trunk at the top, two encoders, the two-stage
    # model's position embedding, the multiplex deconv, domain trans and heads
    "interformer_e2e": (_trunk_rules("", "") + _encoder_rules(
        "single_encoder", "single_global_encoder") + _TWO_STAGE + [
        (r"reduce", lambda m: "reduce"),
        (r"final_layer_(single|multi)", lambda m: f"final_layer_{m[1]}"),
    ], [_qkv("single_encoder", "single_global_encoder"),
        _qkv("multi_encoder", "multi_global_encoder")]),
}
_DECONV = re.compile(r"deconv\d*")
_LEAF = {"scale": "weight", "kernel": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var",
         "rpe_table": "relative_position_bias_table"}


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v, np.float32)


def _module_name(rules, path: str) -> str:
    for pat, fn in rules:
        m = re.fullmatch(pat, path)
        if m:
            return fn(m)
    raise KeyError(f"no port name for JAX module {path!r}")


def _value(module: str, leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and v.ndim == 4:
        if _DECONV.fullmatch(module):  # flipped HWIO -> [I, O, kh, kw]
            return np.flip(v.transpose(2, 3, 0, 1), axis=(2, 3))
        return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and v.ndim == 2:
        return v.T
    return v


def _packed_qkv(packed, module: str):
    """(match, port encoder) where ``module`` is a q/k/v projection of one of
    the ``packed`` encoders, else (None, None)."""
    for rx, owner in packed:
        m = rx.fullmatch(module)
        if m:
            return m, owner
    return None, None


def params_from_jax(variables, model_name: str = "interformer_pureMulti") -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX variable tree (see the module docstring).
    The two-stage names take either first stage, read off the tree
    (TransPose-H's ``singleformer/trunk``, else HRFormer)."""
    params = variables.get("params", {})
    if model_name in TWO_STAGE_NAMES:
        model_name = "transpose_h" if "trunk" in params.get("singleformer", {}) else "hrformer"
    elif model_name in E2E_BUILDERS:
        model_name = "interformer_e2e"
    elif model_name != "interformer_pureMulti":
        raise KeyError(f"params_from_jax: model {model_name!r} is not ported")
    rules, packed = _RULES[model_name]
    leaves = list(_flatten(params)) + list(_flatten(variables.get("batch_stats", {})))
    sd: Dict[str, np.ndarray] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for path, v in leaves:
        module, leaf = path.rsplit("/", 1)
        if path == "singleformer/pos_embedding":  # TransPose-H's learnable embedding
            sd["singleformer.pos_embedding"] = v
            continue
        if path == "single_pos":  # the end-to-end model's learnable embedding
            sd["single_pos_embedding"] = v
            continue
        m, owner = _packed_qkv(packed, module)
        if m:
            base = f"{owner}.layers.{m[1]}.self_attn.in_proj_"
            part = _value(module, leaf, v)
            qkv.setdefault(base + ("weight" if leaf == "kernel" else "bias"), {})[m[2]] = part
            continue
        name = _module_name(rules, module)
        sd[f"{name}.{_LEAF[leaf]}"] = _value(module, leaf, v)
        if leaf == "mean":
            sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
        if leaf == "rpe_table":  # window (2w-1)^2 = table rows
            window = (int(round(np.sqrt(v.shape[0]))) + 1) // 2
            sd[f"{name}.relative_position_index"] = _rpe_index(window).astype(np.int64)
    for name, parts in qkv.items():
        sd[name] = np.concatenate([parts["q"], parts["k"], parts["v"]], axis=0)
    return {k: torch.from_numpy(np.array(v)) for k, v in sorted(sd.items())}  # contiguous copies
