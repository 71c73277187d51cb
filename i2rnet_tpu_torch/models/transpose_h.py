"""TransPose-H, the intra-human (first) stage of the TPH I²R-Net.

Port of ``i2rnet_tpu/models/transpose_h.py:25-85`` (reference
``lib/models/transpose_h.py:416-708``): the HRNet trunk (stem, stages 2-3),
a 1x1 ``reduce`` on branch ``HRNET_RES_LAYER`` (branch 0: 64x48 at 256x192,
48 -> 96 channels), one transformer encoder (``global_encoder``, no key mask)
over all h/4 * w/4 tokens of each person (3072 at 256x192) with the sine (or
learnable) position embedding added to q and k in every layer (in the first
only with ``PE_ONLY_AT_BEGIN``; none with ``POS_EMBEDDING: none``), and a 1x1
``final_layer`` on the encoder output. With ``global_encoder.use_kernels`` the
encoder runs Kernels A and B in eval and Kernels C and D in training (each
where its training route is on), else their plain versions.

Training (the two-stage model's ``train=True``): the trunk's BatchNorms
normalise over the valid persons (the model sets their ``person_mask``), and
the encoder's dropout is keyed by the step's seed from
``INTRA_OFFSET_BASE`` on, apart from the inter encoder's offsets
(``models/encoder.py``). The sine table is a buffer and gets no gradient;
the learnable embedding is a parameter like any other.

State-dict names are the reference's (``conv1``, ``layer1``, ``stage2``...,
``reduce``, ``global_encoder.layers.{i}``, ``final_layer``; the learnable
embedding ``pos_embedding`` as the JAX parameter's ``[h*w, d_model]``). The
sine embedding is a fixed table rebuilt from the shapes, kept out of the
state dict as the JAX tree keeps it out of its parameters.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.models.encoder import INTRA_OFFSET_BASE, TransformerEncoder
from i2rnet_tpu_torch.models.hrnet import HRNetTrunk
from i2rnet_tpu_torch.models.layers import Conv2d
from i2rnet_tpu_torch.models.position import sine_position_embedding_2d


class TransPoseH(HRNetTrunk):
    """``forward(x [P, 3, H, W]) -> (features [P, d_model, H/4, W/4],
    heatmaps [P, K, H/4, W/4] f32)``, the first-stage contract the two-stage
    model composes on (reference ``transpose_h.py:649-655``). ``x`` is in the
    compute dtype; the features stay in it."""

    def __init__(self, extra: Dict, num_joints: int = 17, d_model: int = 96,
                 dim_feedforward: int = 192, n_head: int = 1, encoder_layers: int = 6,
                 image_size: Tuple[int, int] = (192, 256), pos_embedding: str = "sine",
                 res_layer: int = 0, final_conv_kernel: int = 1, pe_only_at_begin: bool = False):
        super().__init__(extra)
        w, h = image_size
        self.feat_hw = (h // 4, w // 4)
        self.d_model = d_model
        self.reduce = Conv2d(self.trunk_channels[res_layer], d_model, 1, bias=False)
        self.res_layer = res_layer
        # [h*w, d_model] added to q and k: the fixed sine table (a buffer kept
        # out of the state dict), a parameter, or none
        if pos_embedding == "sine":
            pe = torch.from_numpy(sine_position_embedding_2d(*self.feat_hw, d_model))
            self.register_buffer("pos_embedding", pe, persistent=False)
        elif pos_embedding == "learnable":
            self.pos_embedding = nn.Parameter(torch.randn(self.feat_hw[0] * self.feat_hw[1],
                                                          d_model))
        elif pos_embedding == "none":
            self.pos_embedding = None
        else:
            raise ValueError(f"MODEL.POS_EMBEDDING={pos_embedding!r}: expected 'sine', "
                             "'learnable' or 'none'")
        self.global_encoder = TransformerEncoder(encoder_layers, d_model, n_head,
                                                 dim_feedforward, offset_base=INTRA_OFFSET_BASE,
                                                 pe_only_at_begin=pe_only_at_begin)
        self.final_layer = Conv2d(d_model, num_joints, final_conv_kernel, 1,
                                  final_conv_kernel // 2)

    def set_routes(self, use_kernels: bool, *fused) -> None:
        """``DEVICE.USE_KERNELS`` for the encoder; the HRFormer block routes
        in ``fused`` have nothing to switch here, and the encoder's training
        routes (``flash_train``, ``fused_ffn_train``) stay as ``build_interformer`` set
        them."""
        self.global_encoder.use_kernels = use_kernels

    def set_remat(self, layers: bool) -> None:
        """``DEVICE.REMAT`` ``layers``: each encoder layer recomputed in training."""
        self.global_encoder.remat = layers

    def encoders(self):
        return [self.global_encoder]

    def forward(self, x, dropout_seed=None, drop_path_scales=None):
        """``dropout_seed`` keys the encoder's dropout in training (unused in
        eval); ``drop_path_scales`` is the first-stage contract's, with no
        DropPath here to take it."""
        p = x.shape[0]
        fh, fw = self.feat_hw
        with tracing.span("model.trunk", device=x):
            feat = self.reduce(self.forward_trunk(x)[self.res_layer])
        if tuple(feat.shape[2:]) != (fh, fw):
            raise ValueError(f"features {tuple(feat.shape[2:])}, expected {(fh, fw)} for the "
                             "configured IMAGE_SIZE")
        # the intra encoder, and the first stage's own heatmaps
        with tracing.span("model.intra", device=x):
            pos = None if self.pos_embedding is None else self.pos_embedding[None].to(feat.dtype)
            tokens = feat.permute(0, 2, 3, 1).reshape(p, fh * fw, self.d_model)
            out = self.global_encoder(tokens, None, pos, dropout_seed)
            out = out.reshape(p, fh, fw, self.d_model).permute(0, 3, 1, 2)
            return out, self.final_layer(out).float()
