"""The eval kernels as registered PyTorch ops, so an exported program runs them.

``torch.export`` cannot see into a wrapper's ctypes launch: traced with fake
tensors it has no ``data_ptr()`` to hand the kernel. Each eval kernel's
wrapper is therefore registered here as an op of the ``i2r`` namespace
(``torch.library.custom_op``) with a fake implementation that gives the
output's shape and dtype. An exported program records the call as an
``i2r::<name>`` node; when the program runs, the op calls the wrapper: on a
CUDA tensor the kernel's launch (counted, or raise), on a CPU tensor its
plain version. There is one launch body per kernel, the wrapper's.

Eager calls do not go through the op, whose dispatch costs host time on every
call: the model's kernel routes take :func:`route`, which hands them the op
only while ``torch.export`` traces, or inside :func:`through_ops` (the FLOP
count of ``tools/compute_flops.py``). The training kernels are not registered,
since nothing exports a training step. Importing ``i2rnet_tpu_torch.ops.cuda``
registers the ops, so a process that loads an artifact finds them.

Each op carries a FLOP formula (``torch.utils.flop_counter``), so
``FlopCounterMode`` counts the kernels it cannot see into: two FLOPs per
multiply-add of the op's plain version, its products and, for the MlpDWBN
ops, its depthwise 3x3 (nine multiply-adds per hidden element). Softmax,
LayerNorm, GELU and the residuals are not counted, as ``FlopCounterMode``
counts no elementwise op; nor is the conv epilogue, which is nothing else.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from i2rnet_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue_fused
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (full_block_fused, mlp_block_fused,
                                                      window_attn_block_fused)
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import mlp_dwbn_fused

NAMESPACE = "i2r"


# E, F, 7 and G take their packed weights as a list (a schema has no optional
# list of tensors): empty where the wrapper is to pack them itself


def _like(x: Tensor) -> Tensor:
    """The fake output: x's shape and dtype, contiguous, as every wrapper returns."""
    return x.new_empty(x.shape)


@torch.library.custom_op("i2r::masked_mhsa", mutates_args=())
def masked_mhsa(q: Tensor, k: Tensor, v: Tensor, num_heads: int,
                key_padding_mask: Optional[Tensor] = None) -> Tensor:
    """Kernel A (:func:`~i2rnet_tpu_torch.ops.cuda.mhsa.masked_mhsa_fused`)."""
    return masked_mhsa_fused(q, k, v, num_heads, key_padding_mask)


@torch.library.custom_op("i2r::encoder_ffn", mutates_args=())
def encoder_ffn(x: Tensor, n1_weight: Tensor, n1_bias: Tensor, w1: Tensor, b1: Tensor,
                w2: Tensor, b2: Tensor, n2_weight: Tensor, n2_bias: Tensor,
                eps: float = 1e-5) -> Tensor:
    """Kernel B (:func:`~i2rnet_tpu_torch.ops.cuda.encoder_ffn.encoder_ffn_fused`)."""
    return encoder_ffn_fused(x, n1_weight, n1_bias, w1, b1, w2, b2, n2_weight, n2_bias, eps)


@torch.library.custom_op("i2r::window_attn_block", mutates_args=())
def window_attn_block(x: Tensor, ln_w: Tensor, ln_b: Tensor, wq: Tensor, bq: Tensor,
                      wk: Tensor, bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor,
                      heads: int, window: int, eps: float,
                      packed: List[Tensor]) -> Tensor:
    """Kernel E (:func:`~i2rnet_tpu_torch.ops.cuda.hrformer_block.window_attn_block_fused`)."""
    return window_attn_block_fused(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads,
                                   window, eps, packed or None)


@torch.library.custom_op("i2r::mlp_block", mutates_args=())
def mlp_block(x: Tensor, ln_w: Tensor, ln_b: Tensor, w1: Tensor, b1: Tensor, dw: Tensor,
              bdw: Tensor, w2: Tensor, b2: Tensor, eps: float,
              packed: List[Tensor]) -> Tensor:
    """Kernel F (:func:`~i2rnet_tpu_torch.ops.cuda.hrformer_block.mlp_block_fused`)."""
    return mlp_block_fused(x, ln_w, ln_b, w1, b1, dw, bdw, w2, b2, eps, packed or None)


@torch.library.custom_op("i2r::full_block", mutates_args=())
def full_block(x: Tensor, ln1_w: Tensor, ln1_b: Tensor, wq: Tensor, bq: Tensor, wk: Tensor,
               bk: Tensor, wv: Tensor, bv: Tensor, wo: Tensor, bo: Tensor, ln2_w: Tensor,
               ln2_b: Tensor, w1: Tensor, b1: Tensor, dw: Tensor, bdw: Tensor, w2: Tensor,
               b2: Tensor, heads: int, window: int, eps: float,
               packed: List[Tensor]) -> Tensor:
    """Kernel 7 (:func:`~i2rnet_tpu_torch.ops.cuda.hrformer_block.full_block_fused`);
    ``packed`` is the wrapper's pair (attention, MLP) of six tensors each, flat."""
    return full_block_fused(x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_w, ln2_b,
                            w1, b1, dw, bdw, w2, b2, heads, window, eps,
                            (packed[:6], packed[6:]) if packed else None)


@torch.library.custom_op("i2r::mlp_dwbn", mutates_args=())
def mlp_dwbn(x: Tensor, w1: Tensor, b1: Tensor, dw: Tensor, bdw: Tensor, w2: Tensor,
             b2: Tensor, packed: List[Tensor]) -> Tensor:
    """Kernel G (:func:`~i2rnet_tpu_torch.ops.cuda.mlp_dwbn.mlp_dwbn_fused`)."""
    return mlp_dwbn_fused(x, w1, b1, dw, bdw, w2, b2, packed or None)


@torch.library.custom_op("i2r::conv_epilogue", mutates_args=())
def conv_epilogue(y: Tensor, bias: Tensor, residual: Optional[Tensor] = None,
                  relu: bool = False) -> Tensor:
    """The conv unit's epilogue
    (:func:`~i2rnet_tpu_torch.ops.cuda.conv_epilogue.conv_epilogue_fused`)."""
    return conv_epilogue_fused(y, bias, residual, relu)


@conv_epilogue.register_fake
def _conv_epilogue_fake(y, bias, residual=None, relu=False):
    return torch.empty_like(y)  # y's layout: channels-last in the trunk


def _full_block_op(*args, packed=None, **kwargs):
    """:func:`full_block` with the wrapper's ``packed`` pair."""
    return full_block(*args, packed=[] if packed is None else [*packed[0], *packed[1]],
                      **kwargs)


for _op in (masked_mhsa, encoder_ffn, window_attn_block, mlp_block, full_block, mlp_dwbn):
    _op.register_fake(lambda x, *args, **kwargs: _like(x))

#: kernel name -> (its wrapper, its registered op)
ROUTES: Dict[str, tuple] = {
    "masked_mhsa": (masked_mhsa_fused, masked_mhsa),
    "encoder_ffn": (encoder_ffn_fused, encoder_ffn),
    "window_attn_block": (window_attn_block_fused, window_attn_block),
    "mlp_block": (mlp_block_fused, mlp_block),
    "full_block": (full_block_fused, _full_block_op),
    "mlp_dwbn": (mlp_dwbn_fused, mlp_dwbn),
    "conv_epilogue": (conv_epilogue_fused, conv_epilogue),
}

class _Routing(threading.local):
    ops = False


_ROUTING = _Routing()


@contextlib.contextmanager
def through_ops():
    """Inside, :func:`route` hands the models the registered ops (this thread)."""
    was = _ROUTING.ops
    _ROUTING.ops = True
    try:
        yield
    finally:
        _ROUTING.ops = was


def route(name: str) -> Callable:
    """Kernel ``name``'s wrapper, or its registered op while ``torch.export``
    traces or inside :func:`through_ops`; both take the wrapper's arguments."""
    wrapper, op = ROUTES[name]
    return op if _ROUTING.ops or torch.compiler.is_exporting() else wrapper


def graph_ops(graph) -> List[str]:
    """The ``i2r::`` ops a ``torch.fx`` graph calls, sorted, each once."""
    found = set()
    for node in graph.nodes:
        target = node.target
        if node.op == "call_function" and isinstance(target, torch._ops.OpOverload) \
                and target.namespace == NAMESPACE:
            found.add(f"{NAMESPACE}::{target._opname}")
    return sorted(found)

# ------------------------------------------------------------------ FLOPs
# two FLOPs a multiply-add, as FlopCounterMode counts a product


def _window_flops(x_shape, heads: int, window: int) -> int:
    """The window-attention half: q, k, v and the output projection over the
    map padded to whole windows, and the two products of each window."""
    p, h, w, c = x_shape
    hp, wp = -(-h // window) * window, -(-w // window) * window
    rows, t = p * hp * wp, window * window
    return 2 * 4 * rows * c * c + 2 * 2 * rows * t * c


def _mlp_flops(x_shape, hidden: int) -> int:
    """MlpDWBN: the two 1x1 products and the depthwise 3x3."""
    p, h, w, c = x_shape
    return 2 * p * h * w * hidden * (2 * c + 9)


# each formula takes the op's arguments (tensors as their shapes) by the
# names of its schema, and FlopCounterMode's out_shape


@register_flop_formula(torch.ops.i2r.masked_mhsa)
def _masked_mhsa_flops(q, k, v, num_heads, key_padding_mask=None, **_) -> int:
    b, s, c = q
    return 2 * 2 * b * s * s * c


@register_flop_formula(torch.ops.i2r.encoder_ffn)
def _encoder_ffn_flops(x, n1_weight, n1_bias, w1, *_, **__) -> int:
    rows = 1
    for n in x[:-1]:
        rows *= n
    return 2 * 2 * rows * x[-1] * w1[0]


@register_flop_formula(torch.ops.i2r.window_attn_block)
def _window_attn_block_flops(x, ln_w, ln_b, wq, bq, wk, bk, wv, bv, wo, bo, heads, window,
                             *_, **__) -> int:
    return _window_flops(x, heads, window)


@register_flop_formula(torch.ops.i2r.mlp_block)
def _mlp_block_flops(x, ln_w, ln_b, w1, *_, **__) -> int:
    return _mlp_flops(x, w1[0])


@register_flop_formula(torch.ops.i2r.full_block)
def _full_block_flops(x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_w, ln2_b, w1, b1, dw,
                      bdw, w2, b2, heads, window, *_, **__) -> int:
    return _window_flops(x, heads, window) + _mlp_flops(x, w1[0])


@register_flop_formula(torch.ops.i2r.mlp_dwbn)
def _mlp_dwbn_flops(x, w1, *_, **__) -> int:
    return _mlp_flops(x, w1[0])
