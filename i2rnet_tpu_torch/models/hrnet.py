"""HRNet multi-resolution trunk (stem + parallel stages), eval path.

Port of ``i2rnet_tpu/models/hrnet.py``. The modules carry the original
PyTorch repo's flat names (``conv1``, ``layer1``, ``transition1``,
``stage2.0.branches.0.0.conv1``, ``stage2.0.fuse_layers.1.0.0.0``...): the
model that owns a trunk subclasses :class:`HRNetTrunk`, as the reference's
models hold these attributes themselves.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch.nn.functional as F
from torch import nn

from i2rnet_tpu_torch.models.layers import BLOCKS, Bottleneck, Conv2d, ConvBN, MaskedBatchNorm, upsample_nearest


class HRStem(nn.Module):
    """conv/2 + conv/2 + 4x Bottleneck(64) -> [B, 256, H/4, W/4]."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = MaskedBatchNorm(64)
        self.conv2 = Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = MaskedBatchNorm(64)
        self.layer1 = nn.Sequential(*[
            Bottleneck(64 if i == 0 else 256, 64, downsample=(i == 0)) for i in range(4)])

    def forward_stem(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        return self.layer1(x)

    forward = forward_stem


class HighResolutionModule(nn.Module):
    """Parallel branches of residual blocks + full multi-scale fusion."""

    def __init__(self, block: str, num_blocks: Sequence[int],
                 in_channels: Sequence[int], num_channels: Sequence[int]):
        super().__init__()
        block_cls = BLOCKS[block]
        exp = block_cls.expansion
        self.num_branches = len(num_channels)
        branches = []
        for i, planes in enumerate(num_channels):
            cin, blocks = in_channels[i], []
            for j in range(num_blocks[i]):
                blocks.append(block_cls(cin, planes,
                                        downsample=(j == 0 and cin != planes * exp)))
                cin = planes * exp
            branches.append(nn.Sequential(*blocks))
        self.branches = nn.ModuleList(branches)
        self.out_channels = [c * exp for c in num_channels]

        self.fuse_layers = None
        if self.num_branches > 1:
            ch = self.out_channels
            fuse = []
            for i in range(self.num_branches):
                row = []
                for j in range(self.num_branches):
                    if j == i:
                        row.append(None)
                    elif j > i:  # 1x1 conv + BN, then nearest upsample 2^(j-i)
                        row.append(ConvBN(ch[j], ch[i], 1, relu=False))
                    else:        # (i-j) stride-2 3x3 convs; ReLU on all but the last
                        row.append(nn.Sequential(*[
                            ConvBN(ch[j], ch[i] if k == i - j - 1 else ch[j], 3, 2,
                                   relu=k < i - j - 1)
                            for k in range(i - j)]))
                fuse.append(nn.ModuleList(row))
            self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs: List):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        if self.fuse_layers is None:
            return outs
        fused = []
        for i, row in enumerate(self.fuse_layers):
            y = None
            for j, layer in enumerate(row):
                if j == i:
                    t = outs[j]
                elif j > i:
                    t = upsample_nearest(layer(outs[j]), 2 ** (j - i))
                else:
                    t = layer(outs[j])
                y = t if y is None else y + t
            fused.append(F.relu(y))
        return fused


class Transition(nn.ModuleList):
    """Stage-to-stage transition (reference ``_make_transition_layer``):
    ``None`` where a branch passes through, ConvBN where its width changes,
    a chain of stride-2 ConvBNs from the last branch for each new one."""

    def __init__(self, pre: Sequence[int], cur: Sequence[int]):
        n_pre = len(pre)
        mods = []
        for i, c in enumerate(cur):
            if i < n_pre:
                mods.append(ConvBN(pre[i], c) if pre[i] != c else None)
            else:
                mods.append(nn.Sequential(*[
                    ConvBN(pre[-1], c if j == i - n_pre else pre[-1], 3, 2)
                    for j in range(i + 1 - n_pre)]))
        super().__init__(mods)
        self.n_pre = n_pre

    def forward(self, xs: List):
        return [(xs[i] if m is None else m(xs[i])) if i < self.n_pre else m(xs[-1])
                for i, m in enumerate(self)]


class HRStage(nn.Sequential):
    """NUM_MODULES HighResolutionModules from a STAGEn cfg dict (the
    transition into the stage is the trunk's ``transition{n-1}``)."""

    def __init__(self, stage_cfg: Dict, in_channels: Sequence[int]):
        mods, ch = [], list(in_channels)
        for _ in range(stage_cfg["NUM_MODULES"]):
            m = HighResolutionModule(stage_cfg["BLOCK"], stage_cfg["NUM_BLOCKS"], ch,
                                     stage_cfg["NUM_CHANNELS"])
            ch = m.out_channels
            mods.append(m)
        super().__init__(*mods)
        self.out_channels = ch


def stage_channels(stage_cfg: Dict) -> List[int]:
    exp = BLOCKS[stage_cfg["BLOCK"]].expansion
    return [c * exp for c in stage_cfg["NUM_CHANNELS"]]


class HRNetTrunk(HRStem):
    """Stem + stage2 + stage3, the HRNet-W48-S trunk of the vanilla I²R-Net
    (reference ``interformer_pureMulti.py:675-704``). ``forward_trunk``
    returns the branch list, highest resolution first."""

    def __init__(self, extra: Dict):
        super().__init__()
        ch2 = stage_channels(extra["STAGE2"])
        self.transition1 = Transition([256], ch2)
        self.stage2 = HRStage(extra["STAGE2"], ch2)
        ch3 = stage_channels(extra["STAGE3"])
        self.transition2 = Transition(self.stage2.out_channels, ch3)
        self.stage3 = HRStage(extra["STAGE3"], ch3)
        self.trunk_channels = self.stage3.out_channels

    def forward_trunk(self, x):
        xs = self.stage2(self.transition1([self.forward_stem(x)]))
        return self.stage3(self.transition2(xs))

    forward = forward_trunk
