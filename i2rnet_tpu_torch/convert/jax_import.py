"""JAX variable tree -> the port's state dict (the original PyTorch names).

``params_from_jax(variables, "interformer_pureMulti")`` takes the JAX model's
``{"params": ..., "batch_stats": ...}`` tree (numpy or jax arrays; read with
``np.asarray`` only) and returns a state dict that
``PureMultiInterFormer.load_state_dict(..., strict=True)`` takes. It is the
exact inverse of ``i2rnet_tpu/convert/torch_import.py::convert_state_dict``:

* names: JAX module paths -> the reference's module names;
* conv kernels HWIO -> OIHW; the deconv's spatially flipped HWIO ->
  ``ConvTranspose2d``'s ``[I, O, kh, kw]``; dense ``[in, out]`` -> ``[out, in]``;
* separate ``q_proj``/``k_proj``/``v_proj`` -> packed ``in_proj_weight``/``in_proj_bias``;
* BN/LN ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var`` (+ ``num_batches_tracked`` = 0).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_CB = {"conv": "0", "bn": "1"}

# JAX module path -> torch module name, for interformer_pureMulti
_RULES = [
    (r"trunk/stem/conv([12])/(conv|bn)", lambda m: f"{m[2]}{m[1]}"),
    (r"trunk/stem/layer1_(\d+)/conv([123])/(conv|bn)", lambda m: f"layer1.{m[1]}.{m[3]}{m[2]}"),
    (r"trunk/stem/layer1_(\d+)/downsample/(conv|bn)",
     lambda m: f"layer1.{m[1]}.downsample.{_CB[m[2]]}"),
    (r"trunk/stage(\d)/transition/t(\d+)/(conv|bn)",
     lambda m: f"transition{int(m[1]) - 1}.{m[2]}.{_CB[m[3]]}"),
    (r"trunk/stage(\d)/transition/t(\d+)_(\d+)/(conv|bn)",
     lambda m: f"transition{int(m[1]) - 1}.{m[2]}.{m[3]}.{_CB[m[4]]}"),
    (r"trunk/stage(\d)/module(\d+)/branch(\d+)_block(\d+)/conv([12])/(conv|bn)",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.{m[6]}{m[5]}"),
    (r"trunk/stage(\d)/module(\d+)/branch(\d+)_block(\d+)/downsample/(conv|bn)",
     lambda m: f"stage{m[1]}.{m[2]}.branches.{m[3]}.{m[4]}.downsample.{_CB[m[5]]}"),
    (r"trunk/stage(\d)/module(\d+)/fuse(\d+)_(\d+)/(conv|bn)",
     lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{_CB[m[5]]}"),
    (r"trunk/stage(\d)/module(\d+)/fuse(\d+)_(\d+)_(\d+)/(conv|bn)",
     lambda m: f"stage{m[1]}.{m[2]}.fuse_layers.{m[3]}.{m[4]}.{m[5]}.{_CB[m[6]]}"),
    (r"reduce", lambda m: "reduce"),
    (r"multi_pos/conv([12])/(conv|bn)", lambda m: f"position_embedding.{m[2]}{m[1]}"),
    (r"encoder/layer(\d+)/self_attn/out_proj",
     lambda m: f"global_encoder.layers.{m[1]}.self_attn.out_proj"),
    (r"encoder/layer(\d+)/(linear[12]|norm[12])",
     lambda m: f"global_encoder.layers.{m[1]}.{m[2]}"),
    (r"deconv", lambda m: "deconv_layers.0"),
    (r"deconv/bn", lambda m: "deconv_layers.1"),
    (r"final_layer", lambda m: "final_layer"),
]
_QKV = re.compile(r"encoder/layer(\d+)/self_attn/([qkv])_proj")
_LEAF = {"scale": "weight", "kernel": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if hasattr(v, "items"):
            yield from _flatten(v, path)
        else:
            yield path, np.asarray(v, np.float32)


def _module_name(path: str) -> str:
    for pat, fn in _RULES:
        m = re.fullmatch(pat, path)
        if m:
            return fn(m)
    raise KeyError(f"no port name for JAX module {path!r}")


def _value(module: str, leaf: str, v: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and v.ndim == 4:
        if module == "deconv":  # flipped HWIO -> [I, O, kh, kw]
            return np.flip(v.transpose(2, 3, 0, 1), axis=(2, 3))
        return v.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and v.ndim == 2:
        return v.T
    return v


def params_from_jax(variables, model_name: str = "interformer_pureMulti") -> Dict[str, torch.Tensor]:
    """The port's state dict from a JAX variable tree (see the module docstring)."""
    if model_name != "interformer_pureMulti":
        raise KeyError(f"params_from_jax: model {model_name!r} is not ported")
    leaves = list(_flatten(variables.get("params", {})))
    leaves += list(_flatten(variables.get("batch_stats", {})))
    sd: Dict[str, np.ndarray] = {}
    qkv: Dict[str, Dict[str, np.ndarray]] = {}
    for path, v in leaves:
        module, leaf = path.rsplit("/", 1)
        m = _QKV.fullmatch(module)
        if m:
            base = f"global_encoder.layers.{m[1]}.self_attn.in_proj_"
            part = _value(module, leaf, v)
            qkv.setdefault(base + ("weight" if leaf == "kernel" else "bias"), {})[m[2]] = part
            continue
        name = _module_name(module)
        sd[f"{name}.{_LEAF[leaf]}"] = _value(module, leaf, v)
        if leaf == "mean":
            sd[f"{name}.num_batches_tracked"] = np.zeros((), np.int64)
    for name, parts in qkv.items():
        sd[name] = np.concatenate([parts["q"], parts["k"], parts["v"]], axis=0)
    return {k: torch.from_numpy(np.array(v)) for k, v in sorted(sd.items())}  # contiguous copies
