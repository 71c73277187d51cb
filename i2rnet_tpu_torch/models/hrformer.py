"""HRFormer-B, the intra-human first stage of the two-stage I²R-Net.

Port of ``i2rnet_tpu/models/hrformer.py`` (reference ``lib/models/
hrformer.py``): a stem (two stride-2 3x3 convs, two Bottlenecks), three stages
of transformer blocks on parallel branches (channels 78·2^i, heads 2^(i+1),
7x7 windows, MLP ratio 4) with multi-scale fusion, and a 1x1 heatmap head on
branch 0. Module names are the reference's (``backbone.stage2.0.branches.0.1
.attn.attn.q_proj``, ``keypoint_head.final_layer``...), so
``convert_state_dict(..., "interformer")`` maps them to the JAX tree.

Layout: the convolutions run NCHW; the transformer blocks take the map as
``[P, H, W, C]`` (the JAX layout, which the kernels take), a view of the
same memory where the map is channels-last. Every convolution and
projection computes in the model's compute dtype, the dtype of the input
map (flax ``dtype=``), whatever dtype the stream has reached. A block runs one
of four routes in eval (``HRFormerBlock.use_kernels``, ``fused_block``,
``fused_onepass``, ``fused_mlp``, from ``DEVICE.USE_KERNELS``,
``FUSED_BLOCK_EVAL``, ``FUSED_BLOCK_EVAL_ONEPASS``, ``FUSED_MLP_EVAL``):

* kernels, fused block and one pass: kernel 7 (``full_block_fused``), the
  whole block in one launch, bit-equal to the next route on every map (the
  JAX package's VMEM gate on this route is a TPU limit and is not carried);
* kernels and fused block: Kernel E (LN1 + window attention + residual), then
  Kernel F (LN2 + BN-folded MlpDWBN + residual);
* kernels and fused MLP only: the modules' attention, then LN2 and Kernel G
  (the BN-folded MlpDWBN) in f32 and the residual, which makes the stream f32
  from that block on, as JAX's promotion does;
* otherwise the modules (LayerNorm, window partition, ``WindowRPEAttention``,
  ``MlpDWBN`` with BatchNorms and erf GELU), as the JAX unfused path.

In training (``module.training``; the two-stage model sets it per call) a
block is ``x + dp(attn(LN1(x)))`` then ``x + dp(MlpDWBN(LN2(x)))`` with the
BatchNorms' batch statistics over the valid persons and DropPath's
per-sample scales (:func:`drop_path_scale`, drawn in
:meth:`HRFormer.forward` from the call's seed); the attention half runs
kernel 9 (``window_attn_block_train_fused``) where ``use_kernels`` and
``fused_train`` (``DEVICE.FUSED_BLOCK_TRAIN``) are on, else the modules.
With ``remat`` (``DEVICE.REMAT`` ``layers``) each block of a training forward
is recomputed in the backward, on either training route
(``models/layers.py::remat``), its DropPath scales handed to the region. The
JAX guard of ``TPU.FUSED_TRAIN_MAX_BLOCKS`` against ``layers``
(``i2rnet_tpu/models/hrformer.py:640-646``) has nothing to guard here: the
port does not carry that key, and every block takes kernel 9 when its route
is on. The relative-position table is carried and not added (the reference
quirk, the default); with ``use_rpe`` (``HRFormer(..., use_rpe=True)``, a
module option no config key reaches, as in JAX) each window's bias, the table
gathered through the index, is added to the f32 logits (JAX
``hrformer.py:121-122,141-142,166-167``), and the block takes the modules in
eval and in training by rule: Kernels E, F, 7 and 9 take no bias, and JAX
leaves its fused kernels off under it (``:324``, ``:332``). Kernel G's route
(the MLP half) stays as it is, as in JAX.
While ``torch.export`` traces, each kernel is its registered ``i2r::`` op
(``ops/cuda/library.py``) and the packed weights are the buffers
``HRFormerBlock.prepare_export`` made.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from i2rnet_tpu_torch.models.hrnet import Transition
from i2rnet_tpu_torch.models.layers import (Bottleneck, Conv2d, ConvBN, LayerNorm, Linear,
                                            MaskedBatchNorm, remat, set_compute_dtype,
                                            upsample_bilinear)
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (pack_attn, window_partition,
                                                      window_unpartition)
from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import window_attn_block_train_fused
from i2rnet_tpu_torch.ops.cuda.library import route
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import fold_bn, pack_mlp, pack_mlp32

#: the HRFormer-B architecture (reference factory ``hrformer.py:2487-2533``,
#: ``i2rnet_tpu/models/hrformer.py:44``)
HRFORMER_B_ARCH = {
    "drop_path_rate": 0.2,
    "stage2": dict(num_modules=1, num_branches=2, num_blocks=(2, 2),
                   num_channels=(78, 156), num_heads=(2, 4),
                   num_mlp_ratios=(4, 4), num_window_sizes=(7, 7)),
    "stage3": dict(num_modules=4, num_branches=3, num_blocks=(2, 2, 2),
                   num_channels=(78, 156, 312), num_heads=(2, 4, 8),
                   num_mlp_ratios=(4, 4, 4), num_window_sizes=(7, 7, 7)),
    "stage4": dict(num_modules=2, num_branches=4, num_blocks=(2, 2, 2, 2),
                   num_channels=(78, 156, 312, 624), num_heads=(2, 4, 8, 16),
                   num_mlp_ratios=(4, 4, 4, 4), num_window_sizes=(7, 7, 7, 7)),
}
STAGES = ("stage2", "stage3", "stage4")
#: the DropPath generator's seed is ``dropout_seed * 2^8 + DROP_PATH_OFFSET``,
#: apart from the encoder's dropout sites (offsets below 4 * layers)
DROP_PATH_OFFSET = 255


def _rpe_index(window: int) -> np.ndarray:
    """Swin-style relative position index [w*w, w*w] into a (2w-1)^2 table
    (``i2rnet_tpu/models/hrformer.py:58``)."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def drop_path_scale(p: int, rate: float, generator: torch.Generator, device):
    """One DropPath draw for ``p`` samples (reference ``hrformer.py:1008-1040``,
    ``i2rnet_tpu/models/hrformer.py:71-84``): ``floor(keep + U[0, 1)) / keep``
    per sample, 0 or 1/keep, keep = 1 - rate; None (the identity) at rate 0,
    after the same draw, so the stream does not depend on the rates."""
    u = torch.rand(p, generator=generator, device=device)
    if rate == 0.0:
        return None
    keep = 1.0 - rate
    return torch.floor(keep + u) / keep


def drop_path(y, scale):
    """``y`` times its sample's scale ``[P]`` (in y's dtype), or ``y`` for None."""
    return y if scale is None else y * scale.to(y.dtype)[:, None, None, None]


class WindowRPEAttention(nn.Module):
    """MHSA over window tokens ``[BW, T, C]`` (reference ``MHA_``,
    ``hrformer.py:590-680``): separate q/k/v/out projections, q scaled by
    d^-1/2 after its projection (bias included). The relative-position table
    and index are carried for the checkpoints, and added to the logits only
    with ``use_rpe``."""

    def __init__(self, channels: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.use_rpe = False
        self.q_proj = Linear(channels, channels)
        self.k_proj = Linear(channels, channels)
        self.v_proj = Linear(channels, channels)
        self.out_proj = Linear(channels, channels)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             torch.from_numpy(_rpe_index(window)).long())

    def forward(self, x):
        bw, t, c = x.shape
        h = self.num_heads
        d = c // h

        def split(a):
            return a.reshape(bw, t, h, d).transpose(1, 2).float()

        q = split(self.q_proj(x)) * (1.0 / math.sqrt(d))
        logits = torch.matmul(q, split(self.k_proj(x)).transpose(-1, -2))
        if self.use_rpe:
            logits = logits + self.bias()[None]
        weights = torch.softmax(logits, dim=-1).to(x.dtype).float()
        out = torch.matmul(weights, split(self.v_proj(x))).to(x.dtype)
        return self.out_proj(out.transpose(1, 2).reshape(bw, t, c))

    def bias(self):
        """The relative-position bias ``[heads, T, T]`` in f32: the table's
        rows at the index."""
        t = self.relative_position_index.shape[0]
        table = self.relative_position_bias_table.float()
        return table[self.relative_position_index.reshape(-1)].reshape(t, t, -1).permute(2, 0, 1)


class InterlacedPoolAttention(nn.Module):
    """Window attention on a ``[B, H, W, C]`` map: center pad, 7x7 windows,
    MHSA, back (reference ``hrformer.py:1138-1180``; ``.attn`` is ``MHA_``)."""

    def __init__(self, channels: int, num_heads: int, window: int):
        super().__init__()
        self.window = window
        self.attn = WindowRPEAttention(channels, num_heads, window)

    def forward(self, x):
        win, info = window_partition(x, self.window)
        return window_unpartition(self.attn(win), self.window, info)


class MlpDWBN(nn.Module):
    """1x1 conv + BN + GELU -> depthwise 3x3 + BN + GELU -> 1x1 + BN + GELU
    over ``[B, H, W, C]`` (reference ``hrformer.py:1044-1137``)."""

    def __init__(self, channels: int, hidden: int):
        super().__init__()
        self.fc1 = Conv2d(channels, hidden, 1)
        self.norm1 = MaskedBatchNorm(hidden)
        self.dw3x3 = Conv2d(hidden, hidden, 3, 1, 1, groups=hidden)
        self.norm2 = MaskedBatchNorm(hidden)
        self.fc2 = Conv2d(hidden, channels, 1)
        self.norm3 = MaskedBatchNorm(channels)

    def forward(self, x):
        y = x.permute(0, 3, 1, 2)
        y = F.gelu(self.norm1(self.fc1(y)))
        y = F.gelu(self.norm2(self.dw3x3(y)))
        y = F.gelu(self.norm3(self.fc2(y)))
        return y.permute(0, 2, 3, 1)

    def folded_params(self):
        """The BN-folded weights for Kernels F and G in f32 (exact in eval):
        ``w1`` [D, C], ``b1`` [D], ``dw`` [D, 3, 3], ``bdw`` [D], ``w2`` [C, D], ``b2`` [C]."""
        out = []
        for conv, bn in ((self.fc1, self.norm1), (self.dw3x3, self.norm2), (self.fc2, self.norm3)):
            k, c = fold_bn(bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
            w = conv.weight.float()
            w = w[:, :, 0, 0] if conv.groups == 1 else w[:, 0]
            out += [w * k.reshape(-1, *([1] * (w.dim() - 1))), conv.bias.float() * k + c]
        return tuple(t.detach() for t in out)


class HRFormerBlock(nn.Module):
    """GeneralTransformerBlock over ``[B, H, W, C]`` (reference
    ``hrformer.py:1182-1242``): ``x + dp(attn(norm1(x)))``, then
    ``x + dp(mlp(norm2(x)))``. The kernel routes are set by the owning model,
    and in training its DropPath scales ``dp_scales`` (see the module
    docstring)."""

    def __init__(self, channels: int, num_heads: int, window: int, mlp_ratio: float,
                 drop_path: float = 0.0, use_rpe: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.drop_path = drop_path  # DropPath rate: the identity in eval
        self.norm1 = LayerNorm(channels)
        self.attn = InterlacedPoolAttention(channels, num_heads, window)
        self.use_rpe = use_rpe
        self.norm2 = LayerNorm(channels)
        self.mlp = MlpDWBN(channels, int(channels * mlp_ratio))
        self.use_kernels = False
        self.fused_block = True
        self.fused_onepass = False
        self.fused_mlp = False
        self.fused_train = False
        self.remat = False  # recompute the block in a training forward's backward
        self.dp_scales = None  # (attention half, MLP half) [P] scales or None, per call
        self._packed = {}

    @property
    def use_rpe(self) -> bool:
        """Whether the attention adds its relative-position bias; the kernel
        routes (E, F, 7, 9) are off while it does."""
        return self.attn.attn.use_rpe

    @use_rpe.setter
    def use_rpe(self, on: bool) -> None:
        self.attn.attn.use_rpe = bool(on)

    def forward(self, x):
        if self.training:
            s_attn, s_mlp = self.dp_scales or (None, None)
            if self.remat:
                return remat(self, self._forward_train, x, s_attn, s_mlp)
            return self._forward_train(x, s_attn, s_mlp)
        if self.use_kernels and self.fused_block and not self.use_rpe:
            a = self.attn.attn
            attn_w = (a.q_proj.weight, a.q_proj.bias, a.k_proj.weight, a.k_proj.bias,
                      a.v_proj.weight, a.v_proj.bias, a.out_proj.weight, a.out_proj.bias)
            if self.fused_onepass:
                return route("full_block")(
                    x, self.norm1.weight, self.norm1.bias, *attn_w, self.norm2.weight,
                    self.norm2.bias, *self._kernel_weights("folded", x), heads=self.num_heads,
                    window=self.window, eps=self.norm1.eps,
                    packed=(self._kernel_weights("attn", x), self._kernel_weights("mlp", x)))
            x = route("window_attn_block")(
                x, self.norm1.weight, self.norm1.bias, *attn_w, heads=self.num_heads,
                window=self.window, eps=self.norm1.eps, packed=self._kernel_weights("attn", x))
            return route("mlp_block")(
                x, self.norm2.weight, self.norm2.bias, *self._kernel_weights("folded", x),
                eps=self.norm2.eps, packed=self._kernel_weights("mlp", x))
        x = x + self.attn(self.norm1(x))
        if self.use_kernels and self.fused_mlp:
            # Kernel G takes LN2's f32 output, as the JAX module hands it; its
            # f32 result joins the residual, so the sum is f32 from here on
            y = F.layer_norm(x.float(), self.norm2.normalized_shape, self.norm2.weight,
                             self.norm2.bias, self.norm2.eps)
            y = route("mlp_dwbn")(y, *self._kernel_weights("folded", x),
                                  packed=self._kernel_weights("mlp32", x))
        else:
            y = self.mlp(self.norm2(x))
        return x + y

    def _forward_train(self, x, s_attn, s_mlp):
        if self.use_kernels and self.fused_train and not self.use_rpe:
            a = self.attn.attn
            s = torch.ones(x.shape[0], device=x.device) if s_attn is None else s_attn
            x = window_attn_block_train_fused(
                x, s, self.norm1.weight, self.norm1.bias, a.q_proj.weight, a.q_proj.bias,
                a.k_proj.weight, a.k_proj.bias, a.v_proj.weight, a.v_proj.bias,
                a.out_proj.weight, a.out_proj.bias, heads=self.num_heads, window=self.window,
                eps=self.norm1.eps)
        else:
            x = x + drop_path(self.attn(self.norm1(x)), s_attn)
        return x + drop_path(self.mlp(self.norm2(x)), s_mlp)

    def _kernel_weights(self, kind: str, x):
        """The weights a kernel route takes, made once per (kind, dtype,
        device) and kept until a parameter or BN statistic changes (its
        version or storage): ``"folded"`` the BN-folded MLP weights,
        ``"attn"``/``"mlp"`` the kernels' packed layouts in x's dtype,
        ``"mlp32"`` Kernel G's TF32 fragments. While ``torch.export`` traces,
        the buffers :meth:`prepare_export` made."""
        if torch.compiler.is_exporting():
            return self._export_weights(kind, x)
        tensors = list(self.parameters()) + list(self.mlp.buffers())
        stamp = tuple((t.data_ptr(), t._version) for t in tensors)
        key = (kind, x.dtype, x.device)
        hit = self._packed.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        val = self._pack(kind, x.dtype, x.device)
        self._packed[key] = (stamp, val)
        return val

    def _pack(self, kind: str, dtype, device):
        with torch.no_grad():
            if kind == "folded":
                return self.mlp.folded_params()
            if kind == "attn":
                a = self.attn.attn
                return pack_attn(a.q_proj.weight, a.q_proj.bias, a.k_proj.weight, a.k_proj.bias,
                                 a.v_proj.weight, a.v_proj.bias, a.out_proj.weight,
                                 a.out_proj.bias, self.num_heads, dtype, device)
            if kind == "mlp32":
                return pack_mlp32(*self._pack("folded", dtype, device), device)
            return pack_mlp(*self._pack("folded", dtype, device), dtype, device)

    def _route_kinds(self):
        """The kernel weights this block's eval route takes."""
        if not self.use_kernels:
            return ()
        if self.fused_block and not self.use_rpe:
            return ("folded", "attn", "mlp")
        return ("folded", "mlp32") if self.fused_mlp else ()

    def prepare_export(self, dtype, device) -> None:
        """Pack the weights this block's eval route takes (the stream in
        ``dtype`` on ``device``) once, into buffers kept out of the state
        dict, which an exported program carries as constants: ``torch.export``
        traces fake parameters, which :meth:`_kernel_weights` can neither
        stamp nor should pack anew at every call."""
        for kind in self._route_kinds():
            for i, t in enumerate(self._pack(kind, dtype, device)):
                self.register_buffer(f"export_{kind}_{i}", t.contiguous(), persistent=False)
        self._export_dtype = dtype

    def _export_weights(self, kind: str, x):
        if not hasattr(self, f"export_{kind}_0"):
            raise RuntimeError("HRFormerBlock: call prepare_export before torch.export")
        if kind in ("attn", "mlp") and x.dtype != self._export_dtype:
            raise RuntimeError(f"HRFormerBlock: weights packed for {self._export_dtype}, "
                               f"the stream is {x.dtype}")
        return tuple(getattr(self, f"export_{kind}_{i}") for i in range(6))


def _fuse_layers(channels: List[int], n_out: int) -> nn.ModuleList:
    """Reference HRT fusion (``hrformer.py:1616-1705``): for output i, input
    j > i a 1x1 ConvBN (then bilinear up), j < i a chain of (depthwise 3x3/s2
    + BN + 1x1 + BN [+ ReLU except last])."""
    rows = []
    for i in range(n_out):
        row = []
        for j in range(len(channels)):
            if j == i:
                row.append(None)
            elif j > i:
                row.append(ConvBN(channels[j], channels[i], 1, relu=False))
            else:
                cj, chain = channels[j], []
                for k in range(i - j):
                    last = k == i - j - 1
                    cout = channels[i] if last else cj
                    mods = [Conv2d(cj, cj, 3, 2, 1, groups=cj, bias=False), MaskedBatchNorm(cj),
                            Conv2d(cj, cout, 1, bias=False), MaskedBatchNorm(cout)]
                    if not last:
                        mods.append(nn.ReLU())
                    chain.append(nn.Sequential(*mods))
                row.append(nn.Sequential(*chain))
        rows.append(nn.ModuleList(row))
    return nn.ModuleList(rows)


class HRTModule(nn.Module):
    """One module of an HRT stage: the branches' transformer blocks, then
    the fusion (only branch 0's output when ``multi_scale_output`` is off)."""

    def __init__(self, cfg: Dict, drop_paths, multi_scale_output: bool):
        super().__init__()
        ch = list(cfg["num_channels"])
        nb = cfg["num_branches"]
        per = cfg["num_blocks"][0]
        self.branches = nn.ModuleList([
            nn.Sequential(*[HRFormerBlock(ch[b], cfg["num_heads"][b], cfg["num_window_sizes"][b],
                                          float(cfg["num_mlp_ratios"][b]), drop_paths[k])
                            for k in range(per)])
            for b in range(nb)])
        self.fuse_layers = _fuse_layers(ch, nb if multi_scale_output else 1)

    def forward(self, xs: List):
        # blocks on [B, H, W, C]; the NCHW view of the result is channels-last
        return self.fuse([branch(x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)
                          for branch, x in zip(self.branches, xs)])

    def fuse(self, outs: List) -> List:
        """The multi-scale fusion of the branches' NCHW maps (JAX ``HRTFuse``)."""
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = outs[j]
                elif j > i:
                    t = upsample_bilinear(layer(outs[j]), outs[i].shape[2:])
                else:
                    t = layer(outs[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


class HRFormerBackbone(nn.Module):
    """The HighResolutionTransformer: stem, ``transition{1,2,3}`` and
    ``stage{2,3,4}``; returns branch 0's map ``[P, 78, H/4, W/4]``."""

    def __init__(self, arch: Dict):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = MaskedBatchNorm(64)
        self.conv2 = Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = MaskedBatchNorm(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, downsample=True), Bottleneck(256, 64))
        depths = [arch[s]["num_modules"] * arch[s]["num_blocks"][0] for s in STAGES]
        dpr = list(np.linspace(0, arch["drop_path_rate"], sum(depths)))
        pre, o = [256], 0
        for si, s in enumerate(STAGES):
            cfg = arch[s]
            ch = list(cfg["num_channels"])
            per = cfg["num_blocks"][0]
            mso = cfg.get("multiscale_output", s != "stage4")
            setattr(self, f"transition{si + 1}", Transition(pre, ch))
            setattr(self, s, nn.Sequential(*[
                HRTModule(cfg, dpr[o + m * per:o + (m + 1) * per],
                          mso or m < cfg["num_modules"] - 1)
                for m in range(cfg["num_modules"])]))
            pre, o = ch, o + depths[si]

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for si, s in enumerate(STAGES):
            xs = getattr(self, s)(getattr(self, f"transition{si + 1}")(xs))
        return xs[0]


class KeypointHead(nn.Module):
    """``TopDownSimpleHead`` without deconvs: the 1x1 ``final_layer``."""

    def __init__(self, channels: int, num_joints: int):
        super().__init__()
        self.final_layer = Conv2d(channels, num_joints, 1)

    def forward(self, x):
        return self.final_layer(x)


class HRFormer(nn.Module):
    """HRFormer-B pose model: ``forward(x [P, 3, H, W]) -> (branch-0 features
    [P, 78, H/4, W/4], heatmaps [P, K, H/4, W/4] f32)``, the first-stage
    contract (reference ``hrformer.py:2470-2480``)."""

    def __init__(self, arch: Dict, num_joints: int = 17, use_rpe: bool = False):
        super().__init__()
        self.backbone = HRFormerBackbone(arch)
        self.keypoint_head = KeypointHead(arch["stage2"]["num_channels"][0], num_joints)
        for blk in self.blocks():
            blk.use_rpe = use_rpe

    def blocks(self):
        return [m for m in self.modules() if isinstance(m, HRFormerBlock)]

    def set_routes(self, use_kernels: bool, fused_block: bool, fused_mlp: bool,
                   fused_train: bool = False, fused_onepass: bool = False) -> None:
        for blk in self.blocks():
            blk.use_kernels, blk.fused_block = use_kernels, fused_block
            blk.fused_mlp, blk.fused_train = fused_mlp, fused_train
            blk.fused_onepass = fused_onepass

    def set_remat(self, layers: bool) -> None:
        """``DEVICE.REMAT`` ``layers``: each block recomputed in training."""
        for blk in self.blocks():
            blk.remat = layers

    def encoders(self):
        """No transformer encoder: the blocks run their own kernels."""
        return []

    def forward(self, x, dropout_seed: Optional[int] = None, drop_path_scales=None):
        """``x`` ``[P, 3, H, W]`` in the compute dtype. In training the blocks'
        DropPath scales come from ``dropout_seed`` (one draw of ``[P]`` per
        block half, in :meth:`blocks` order), or are ``drop_path_scales``, a
        sequence of (attention, MLP) scale pairs per block (tests)."""
        set_compute_dtype(self, x.dtype)
        blocks = self.blocks()
        if self.training:
            scales = self._drop_path_scales(x.shape[0], x.device, dropout_seed, drop_path_scales)
            for blk, pair in zip(blocks, scales):
                blk.dp_scales = pair
        try:
            feat = self.backbone(x)
        finally:
            for blk in blocks:
                blk.dp_scales = None
        return feat, self.keypoint_head(feat).float()

    def _drop_path_scales(self, p, device, dropout_seed, given):
        blocks = self.blocks()
        if given is not None:
            if len(given) != len(blocks):
                raise ValueError(f"drop_path_scales: {len(given)} pairs for {len(blocks)} blocks")
            return [tuple(pair) for pair in given]
        if all(blk.drop_path == 0.0 for blk in blocks):
            return [None] * len(blocks)
        if dropout_seed is None:
            raise ValueError("a training forward with DropPath needs dropout_seed")
        g = torch.Generator(device=device).manual_seed((int(dropout_seed) << 8) + DROP_PATH_OFFSET)
        return [tuple(drop_path_scale(p, blk.drop_path, g, device) for _ in range(2))
                for blk in blocks]
