"""End-to-end I²R-Net (``interformer_e2e``, ``interformer_e2e_new``).

Port of ``i2rnet_tpu/models/interformer_e2e.py:37-200`` (reference
``lib/models/interformer_e2e.py:419-872`` and ``interformer_e2e_new.py``):
one module holding the HRNet-W48-S trunk, a per-person intra encoder and the
cross-person inter encoder, trained jointly:

* the trunk's branch ``HRNET_RES_LAYER`` reduced 1x1 to ``DIM_MODEL``
  (branch 0: 64x48 at 256x192, 48 -> 96 channels);
* the intra encoder (``single_global_encoder``, ``ENCODER_SINGLE_LAYERS``)
  over each person's fh*fw tokens with no key mask (3072 at 256x192, the
  TransPose-H intra shape), the ``sine`` table (a buffer out of the state
  dict) or a ``learnable`` one (``single_pos_embedding``, the JAX
  ``single_pos``) added to q and k in every layer;
* ONE deconv block (``deconv_layers``) reused for every 2x step, as the
  reference's multiplex: ``log2(48 / fw)`` steps for ``single``, then
  ``log2(fw / tw)`` after the inter encoder and ``log2(48 / fw)`` after the
  residual; each application moves its BatchNorm's running statistics, as
  Flax commits each call's ``batch_stats``;
* 3x3/s2 max pools down to ``TRANS_SIZE``, the inter encoder
  (``multi_global_encoder``, ``ENCODER_MUTI_LAYERS``, the reference's
  spelling) over all persons' tokens with the key-padding mask and the box-mask
  position embedding (``multi_position_embedding``, mode ``conv`` or ``res``);
* the residual on the intra features, with ``DOMAIN_TRANS`` a 1x1 conv on
  each operand (``domain_trans_{1,2}``);
* one shared ``final_layer`` (``interformer_e2e``) or ``final_layer_single``
  and ``final_layer_multi`` (``interformer_e2e_new``);
* returns ``{"single", "multi"}`` heatmaps ``[B, N, K, H/4, W/4]`` (f32),
  padded persons zeroed.

The two encoders share the step's dropout seed on disjoint offsets (the
intra encoder from ``INTRA_OFFSET_BASE``, as TransPose-H's). With
``use_kernels`` both run Kernels A and B in eval and C and D in training, and
the trunk's folded eval conv units the epilogue kernel.
``train=True`` is the JAX ``train=True`` as
:class:`~.pure_multi.PureMultiInterFormer` has it; ``DEVICE.REMAT``
``layers`` recomputes each layer of both encoders. The state-dict names are
the reference's, so ``convert_state_dict(sd, "interformer_e2e")`` maps them
to the JAX tree. The reference builds ``domain_trans_{1,2}`` even with
``DOMAIN_TRANS`` off; the port, as the JAX model, only with it on.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from i2rnet_tpu_torch.models.encoder import (INTRA_OFFSET_BASE, TransformerEncoder,
                                             flatten_person_tokens)
from i2rnet_tpu_torch.models.hrnet import HRNetTrunk
from i2rnet_tpu_torch.models.layers import (Conv2d, DeconvBlock, max_pool_3x3_s2, remat_layers,
                                            set_conv_kernels, training_call)
from i2rnet_tpu_torch.models.position import PositionEmbeddingImage, sine_position_embedding_2d
from i2rnet_tpu_torch.models.pure_multi import DTYPES, set_train_routes


class InterFormerE2E(HRNetTrunk):
    """``forward(images [B,N,H,W,3], pos_masks [B,N,H,W,1], person_valid [B,N],
    train=False, dropout_seed=None) -> {"single", "multi"}``."""

    def __init__(self, extra: Dict, num_joints: int = 17, d_model: int = 96,
                 dim_feedforward: int = 192, n_head: int = 1, encoder_single_layers: int = 4,
                 encoder_multi_layers: int = 2, image_size=(192, 256), trans_size=(16, 12),
                 heatmap_size=(48, 64), single_pos_embedding: str = "sine",
                 use_multi_pos: bool = True, multi_pos_mode: str = "conv",
                 domain_trans: bool = False, res_layer: int = 0, separate_heads: bool = False,
                 final_conv_kernel: int = 1, use_kernels: bool = False, remat=False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(extra)
        w, h = image_size
        stride = 4 * 2 ** res_layer
        self.feat_hw = (h // stride, w // stride)
        fh, fw = self.feat_hw
        self.trans_size = tuple(trans_size)
        self.d_model = d_model
        self.res_layer = res_layer
        self.compute_dtype = compute_dtype
        self.single_steps = int(math.log2(heatmap_size[0] // fw))
        self.pool_steps = int(math.log2(fw // self.trans_size[1]))
        self.reduce = Conv2d(self.trunk_channels[res_layer], d_model, 1, bias=False)
        if single_pos_embedding == "sine":
            pe = torch.from_numpy(sine_position_embedding_2d(fh, fw, d_model))
            self.register_buffer("single_pos_embedding", pe, persistent=False)
        elif single_pos_embedding == "learnable":
            self.single_pos_embedding = nn.Parameter(torch.randn(fh * fw, d_model))
        else:
            self.single_pos_embedding = None
        layers = remat_layers(remat)
        self.single_global_encoder = TransformerEncoder(
            encoder_single_layers, d_model, n_head, dim_feedforward, use_kernels,
            offset_base=INTRA_OFFSET_BASE, remat=layers)
        self.multi_global_encoder = TransformerEncoder(
            encoder_multi_layers, d_model, n_head, dim_feedforward, use_kernels, remat=layers)
        if set(self.single_global_encoder.offsets()) & set(self.multi_global_encoder.offsets()):
            raise ValueError(f"{encoder_multi_layers} inter layers take dropout offsets of the "
                             "intra encoder")
        self.multi_position_embedding = (PositionEmbeddingImage(self.trans_size, d_model,
                                                                multi_pos_mode)
                                         if use_multi_pos else None)
        filters = extra["NUM_DECONV_FILTERS"][0]
        self.deconv_layers = DeconvBlock(d_model, filters, extra["NUM_DECONV_KERNELS"][0],
                                         bias=extra.get("DECONV_WITH_BIAS", False))
        self.domain_trans = domain_trans
        if domain_trans:
            self.domain_trans_1 = Conv2d(d_model, d_model, 1)
            self.domain_trans_2 = Conv2d(filters, d_model, 1)
        k = final_conv_kernel
        self.separate_heads = separate_heads
        if separate_heads:
            self.final_layer_single = Conv2d(d_model, num_joints, k, 1, k // 2)
            self.final_layer_multi = Conv2d(d_model, num_joints, k, 1, k // 2)
        else:
            self.final_layer = Conv2d(d_model, num_joints, k, 1, k // 2)
        set_conv_kernels(self, use_kernels)

    def set_kernels(self, use_kernels: bool) -> None:
        """``DEVICE.USE_KERNELS``: both encoders on Kernels A and B (C and D
        in training), the trunk's folded eval conv units on the epilogue kernel."""
        for encoder in self.encoders():
            encoder.use_kernels = use_kernels
        set_conv_kernels(self, use_kernels)

    def encoders(self):
        """The intra encoder, then the inter encoder."""
        return [self.single_global_encoder, self.multi_global_encoder]

    def forward(self, images, pos_masks, person_valid, train: bool = False,
                dropout_seed: Optional[int] = None):
        with training_call(self, train, person_valid):
            return self._forward(images, pos_masks, person_valid, dropout_seed)

    def _up(self, x, steps: int):
        for _ in range(steps):
            x = self.deconv_layers(x)
        return x

    def _forward(self, images, pos_masks, person_valid, dropout_seed):
        b, n, h, w, _ = images.shape
        th, tw = self.trans_size
        fh, fw = self.feat_hw
        dt = self.compute_dtype
        x = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2).to(dt)
        x = self.reduce(self.forward_trunk(x)[self.res_layer])
        if tuple(x.shape[2:]) != (fh, fw):
            raise ValueError(f"features {tuple(x.shape[2:])}, expected {(fh, fw)} for the "
                             "configured IMAGE_SIZE")
        pos = (None if self.single_pos_embedding is None
               else self.single_pos_embedding[None].to(x.dtype))
        tokens = x.permute(0, 2, 3, 1).reshape(b * n, fh * fw, self.d_model)
        tokens = self.single_global_encoder(tokens, None, pos, dropout_seed)
        x = tokens.reshape(b * n, fh, fw, self.d_model).permute(0, 3, 1, 2)
        single = self._up(x, self.single_steps)

        feat = x
        for _ in range(self.pool_steps):
            feat = max_pool_3x3_s2(feat)
        tokens = feat.permute(0, 2, 3, 1).reshape(b, n * th * tw, self.d_model)
        key_pad = (~person_valid).repeat_interleave(th * tw, dim=1)
        mp = None
        if self.multi_position_embedding is not None:
            mp = flatten_person_tokens(self.multi_position_embedding(pos_masks.to(dt))).to(
                tokens.dtype)
        out = self.multi_global_encoder(tokens, key_pad, mp, dropout_seed)
        out = out.reshape(b * n, th, tw, self.d_model).permute(0, 3, 1, 2)
        out = self._up(out, self.pool_steps)
        if self.domain_trans:
            out = self.domain_trans_1(x) + self.domain_trans_2(out)
        else:
            out = x + out
        out = self._up(out, self.single_steps)

        if self.separate_heads:
            hs, hm = self.final_layer_single(single), self.final_layer_multi(out)
        else:
            hs, hm = self.final_layer(single), self.final_layer(out)
        vmask = person_valid[:, :, None, None, None]

        def to_out(t):
            t = t.reshape(b, n, *t.shape[1:])
            return (t * vmask.to(t.dtype)).float()

        return {"single": to_out(hs), "multi": to_out(hm)}


def _build(cfg: Dict, use_kernels: Optional[bool], device, separate_heads: bool):
    m, dev = cfg["MODEL"], cfg["DEVICE"]
    model = InterFormerE2E(
        extra=m["EXTRA"], num_joints=m["NUM_JOINTS"], d_model=m["DIM_MODEL"],
        dim_feedforward=m["DIM_FEEDFORWARD"], n_head=m["N_HEAD"],
        encoder_single_layers=m.get("ENCODER_SINGLE_LAYERS", 4),
        encoder_multi_layers=m.get("ENCODER_MUTI_LAYERS", 2),
        image_size=tuple(m["IMAGE_SIZE"]), trans_size=tuple(m["TRANS_SIZE"]),
        heatmap_size=tuple(m["HEATMAP_SIZE"]),
        single_pos_embedding=m.get("SINGLE_POS_EMBEDDING", "sine"),
        use_multi_pos=m.get("USE_MULTI_POS", True),
        multi_pos_mode=m.get("MULTI_POS_EMBEDDING", "conv"),
        domain_trans=m.get("DOMAIN_TRANS", False), res_layer=m.get("HRNET_RES_LAYER", 0),
        separate_heads=separate_heads,
        final_conv_kernel=m["EXTRA"].get("FINAL_CONV_KERNEL", 1),
        use_kernels=dev["USE_KERNELS"] if use_kernels is None else use_kernels,
        remat=dev.get("REMAT", False), compute_dtype=DTYPES[dev["COMPUTE_DTYPE"]])
    for encoder in model.encoders():
        set_train_routes(encoder, dev)
    return model.to(device).eval()


def build_interformer_e2e(cfg: Dict, use_kernels: Optional[bool] = None,
                          device="cuda") -> InterFormerE2E:
    """``interformer_e2e`` (one shared final conv) from a port config, in
    eval mode, on ``device`` (the card unless asked). ``use_kernels``
    defaults to ``DEVICE.USE_KERNELS``; ``ENCODER_SINGLE_LAYERS`` and
    ``ENCODER_MUTI_LAYERS`` default to 4 and 2, as the JAX builder reads them."""
    return _build(cfg, use_kernels, device, separate_heads=False)


def build_interformer_e2e_new(cfg: Dict, use_kernels: Optional[bool] = None,
                              device="cuda") -> InterFormerE2E:
    """``interformer_e2e_new``: as :func:`build_interformer_e2e`, with a final
    conv for each branch."""
    return _build(cfg, use_kernels, device, separate_heads=True)


#: the builder of each end-to-end model name
E2E_BUILDERS = {"interformer_e2e": build_interformer_e2e,
                "interformer_e2e_new": build_interformer_e2e_new}
