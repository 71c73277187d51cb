"""The yardstick's arithmetic: the card's peaks, the model FLOPs of the
valid persons, and the least time of the encoder attention's work.

Model FLOPs are counted on the benchmark's own reference at the cell's
shapes (``torch.utils.flop_counter.FlopCounterMode`` over a forward, or a
forward and backward, on the ``meta`` device): convolutions and matrix
products, two FLOPs a multiply-add, for one image row of m valid persons,
so attention covers the keys the person mask leaves. Normalisation,
softmax, activations and dropout are not counted. The count is the same
whatever implements the work.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_h100.reference.nets import Net

#: NVIDIA H100 SXM data sheet: dense bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def _meta_params(names_shapes):
    return {name: torch.empty(shape, device="meta") for name, shape in names_shapes}


def _count(fn) -> int:
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return int(counter.get_total_flops())


@functools.lru_cache(maxsize=None)
def _row_flops(cfg_json: str, shapes_json: str, persons: int, backward: bool) -> int:
    cfg = json.loads(cfg_json)
    params = _meta_params([(n, tuple(s)) for n, s in json.loads(shapes_json)])
    w, h = cfg["MODEL"]["IMAGE_SIZE"]

    def run():
        if backward:
            for t in params.values():
                t.requires_grad_(True)
        net = Net(params, cfg)
        net.train = backward  # batch statistics; dropout stays off (rate 0)
        x = torch.empty(1, persons, h, w, 3, device="meta")
        pm = torch.empty(1, persons, h, w, 1, device="meta")
        valid = torch.ones(1, persons, dtype=torch.bool, device="meta")
        heat = net(x, pm, valid)
        if backward:
            heat.sum().backward()

    return _count(run)


def row_flops(cfg, names_shapes, persons: int, backward: bool = False) -> int:
    """FLOPs of one forward (with ``backward``: forward and backward) of one
    image row of ``persons`` valid persons."""
    shapes = json.dumps([[n, list(s)] for n, s in names_shapes])
    return _row_flops(json.dumps(cfg, sort_keys=True), shapes, int(persons), bool(backward))


def attention_work(tokens: int, channels: int):
    """(FLOPs, activation bytes) of the encoder self-attention
    (``SelfAttention``: the q, k, v and output projections and the two
    products) over ``tokens`` tokens that attend to each other: multiply-adds
    4 S C^2 + 2 S^2 C, two FLOPs each, whatever the heads; bytes the two bf16
    inputs (q = k = x + pos, and v = x) and the bf16 output."""
    s, c = int(tokens), int(channels)
    return 2 * (4 * s * c * c + 2 * s * s * c), 3 * s * c * 2


def weight_bytes(channels: int) -> int:
    """The float32 projection weights and biases a call reads once."""
    c = int(channels)
    return (4 * c * c + 4 * c) * 4


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card takes: the larger of the two roofline terms."""
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)


def attention_layers(cfg):
    """[(tokens a valid person brings, layers, per row or per person)] of the
    model's encoders: the inter encoder attends over a row's persons, the
    TransPose-H intra encoder over each person alone."""
    m = cfg["MODEL"]
    th, tw = m["TRANS_SIZE"]
    if m["NAME"] == "interformer_pureMulti":
        return [(th * tw, m["ENCODER_LAYERS"], "row")]
    w, h = m["IMAGE_SIZE"]
    return [((h // 4) * (w // 4), m["ENCODER_LAYERS"], "person"),
            (th * tw, m["ENCODER_MULTI_LAYERS"], "row")]


def attention_bound(cfg, calls, passes: int = 1, factor: int = 1) -> float:
    """The least seconds of the attention work of ``calls``: each a list of
    the valid persons of the rows one batched call carried. Each layer's
    call over the batch is bound on its own, ``passes`` times (2 for the
    flip test); ``factor`` 3 counts a backward as twice the forward."""
    c = cfg["MODEL"]["DIM_MODEL"]
    total = 0.0
    for rows in calls:
        for tokens, layers, unit in attention_layers(cfg):
            fl, nb = 0, weight_bytes(c)
            for m in rows:
                if unit == "row":
                    f, b = attention_work(tokens * m, c)
                else:
                    f, b = (v * m for v in attention_work(tokens, c))
                fl, nb = fl + f, nb + b
            total += layers * passes * bound_seconds(factor * fl, factor * nb)
    return total
