"""Two-stage I²R-Net (``interformer``) with the HRFormer-B first stage.

Port of ``i2rnet_tpu/models/interformer.py:59-231`` for the released HRT
recipe (``experiments/coco/interformer_coco_hrt_192_p2_b12.yaml``):

* the first stage (``singleformer``, :class:`~.hrformer.HRFormer`) runs per
  person on the flattened [B*N] axis -> (features, single heatmaps);
* the features are max-pooled (3x3/s2) floor(log2(W/4 / TRANS_W)) times; the
  pooled map is the token grid (64x48 -> 16x12 at 256x192);
* the inter encoder (``multi_global_encoder``, Kernels A and B with
  ``DEVICE.USE_KERNELS``) over all persons' tokens of an image, key-padding
  mask from ``person_valid``, no position embedding;
* two separate deconv blocks back to the heatmap size
  (``upsample_layer.deconv_layers.{i}``), the residual on the first-stage
  features, the 1x1 ``final_layer``, padded persons zeroed;
* returns ``{"single", "multi"}`` heatmaps ``[B, N, K, H/4, W/4]`` (f32;
  ``single`` None unless inter-supervision is on and the first stage trains).

``forward(..., train=True, dropout_seed=...)`` is the JAX ``train=True`` as
:class:`~.pure_multi.PureMultiInterFormer` has it: training mode for the call,
every BatchNorm (first stage, deconvs) over the valid persons, the first
stage's DropPath and the encoder's dropout keyed by the seed. A frozen first
stage (``SINGLEFORMER_FIX``, ``DEVICE.FROZEN_STAGE_EVAL_MODE``) and
``DEVICE.REMAT`` are not ported: a training forward with them raises.

:func:`build_model` builds either ported model from a port config, on the
card unless asked otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from i2rnet_tpu_torch.models.encoder import TransformerEncoder
from i2rnet_tpu_torch.models.hrformer import HRFORMER_B_ARCH, HRFormer
from i2rnet_tpu_torch.models.layers import Conv2d, DeconvBlock, max_pool_3x3_s2, training_call
from i2rnet_tpu_torch.models.pure_multi import DTYPES, build_pure_multi, set_train_routes


class DeconvUpsample(nn.Module):
    """The reference ``DeConv`` wrapper: ``steps`` separate deconv blocks."""

    def __init__(self, cin: int, filters: int, kernel: int, steps: int, bias: bool):
        super().__init__()
        self.deconv_layers = nn.Sequential(*[
            DeconvBlock(cin if i == 0 else filters, filters, kernel, bias) for i in range(steps)])

    def forward(self, x):
        return self.deconv_layers(x)


class InterFormer(nn.Module):
    """``forward(images [B,N,H,W,3], pos_masks, person_valid [B,N], train=False,
    dropout_seed=None) -> {"single", "multi"}`` (``pos_masks`` unused without a
    multi-person position embedding). ``compute_dtype`` is
    ``DEVICE.COMPUTE_DTYPE``; :meth:`set_kernels` switches every kernel route
    at once."""

    def __init__(self, arch: Dict, extra: Dict, num_joints: int = 17, d_model: int = 78,
                 dim_feedforward: int = 192, n_head: int = 1, encoder_layers: int = 2,
                 trans_size=(16, 12), heatmap_size=(48, 64), inter_supervision: bool = True,
                 singleformer_fix: bool = False, frozen_stage_eval: bool = False,
                 remat=False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trans_size = tuple(trans_size)
        self.d_model = d_model
        self.compute_dtype = compute_dtype
        self.return_single = inter_supervision and not singleformer_fix
        # training options not ported: (config key, value) pairs that are set
        self.unported_training = [(k, v) for k, v in (
            ("MODEL.SINGLEFORMER_FIX", singleformer_fix),
            ("DEVICE.FROZEN_STAGE_EVAL_MODE", frozen_stage_eval),
            ("DEVICE.REMAT", remat)) if v not in (False, None, "none")]
        self.singleformer = HRFormer(arch, num_joints)
        self.multi_global_encoder = TransformerEncoder(encoder_layers, d_model, n_head,
                                                       dim_feedforward)
        # the deconv steps from the pooled width, as the JAX model reads it off
        # the pooled map (3x3/s2 pools with padding 1 take w to ceil(w / 2))
        tw = heatmap_size[0]
        for _ in range(int(math.log2(heatmap_size[0] // self.trans_size[1]))):
            tw = (tw + 1) // 2
        steps = int(math.log2(heatmap_size[0] // tw))
        filters = extra["NUM_DECONV_FILTERS"][0]
        self.upsample_layer = DeconvUpsample(d_model, filters, extra["NUM_DECONV_KERNELS"][0],
                                             steps, extra.get("DECONV_WITH_BIAS", False))
        k = extra.get("FINAL_CONV_KERNEL", 1)
        self.final_layer = Conv2d(filters, num_joints, k, 1, k // 2)

    def set_kernels(self, use_kernels: bool, fused_block: bool = True,
                    fused_mlp: bool = False, fused_train: bool = False,
                    fused_onepass: bool = False) -> None:
        """``DEVICE.USE_KERNELS`` (all routes), ``FUSED_BLOCK_EVAL`` (Kernels
        E + F), ``FUSED_MLP_EVAL`` (Kernel G, where E + F are off),
        ``FUSED_BLOCK_TRAIN`` (kernel 9 in training) and
        ``FUSED_BLOCK_EVAL_ONEPASS`` (kernel 7 in place of E + F)."""
        self.multi_global_encoder.use_kernels = use_kernels
        self.singleformer.set_routes(use_kernels, fused_block, fused_mlp, fused_train,
                                     fused_onepass)

    def forward(self, images, pos_masks, person_valid, train: bool = False,
                dropout_seed: Optional[int] = None, drop_path_scales=None):
        if (train or self.training) and self.unported_training:
            raise NotImplementedError(f"training with {self.unported_training} is not ported")
        with training_call(self, train, person_valid):
            return self._forward(images, person_valid, dropout_seed, drop_path_scales)

    def _forward(self, images, person_valid, dropout_seed, drop_path_scales):
        b, n, h, w, _ = images.shape
        x = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2).to(self.compute_dtype)
        feat, single_heat = self.singleformer(x, dropout_seed, drop_path_scales)
        single_res = feat
        for _ in range(int(math.log2(feat.shape[3] // self.trans_size[1]))):
            feat = max_pool_3x3_s2(feat)
        th, tw = feat.shape[2], feat.shape[3]
        tokens = feat.permute(0, 2, 3, 1).reshape(b, n * th * tw, self.d_model)
        key_pad = (~person_valid).repeat_interleave(th * tw, dim=1)
        out = self.multi_global_encoder(tokens, key_pad, None, dropout_seed)
        out = out.reshape(b * n, th, tw, self.d_model).permute(0, 3, 1, 2)
        out = single_res + self.upsample_layer(out)
        heat = self.final_layer(out)
        vmask = person_valid[:, :, None, None, None]
        heat = heat.reshape(b, n, *heat.shape[1:])
        multi = (heat * vmask.to(heat.dtype)).float()
        single = None
        if self.return_single:
            single = (single_heat.reshape(b, n, *single_heat.shape[1:]) * vmask.float()).float()
        return {"single": single, "multi": multi}


def build_interformer(cfg: Dict, use_kernels: Optional[bool] = None,
                      device="cuda") -> InterFormer:
    """The HRFormer two-stage model from a port config, in eval mode, on
    ``device``. ``use_kernels`` defaults to ``DEVICE.USE_KERNELS``."""
    m, dev = cfg["MODEL"], cfg["DEVICE"]
    if m.get("SINGLEFORMER") != "hrformer":
        raise NotImplementedError(f"MODEL.SINGLEFORMER={m.get('SINGLEFORMER')!r}: only "
                                  "'hrformer' is ported")
    for key, ported in (("UPSAMPLE_TYPE", "deconv"), ("ATTENTION_TYPE", "default"),
                        ("DOMAIN_TRANS", False), ("USE_MULTI_POS", False)):
        if m.get(key, ported) != ported:
            raise NotImplementedError(f"MODEL.{key}={m[key]!r} is not ported")
    model = InterFormer(
        arch=m.get("HRFORMER_ARCH") or HRFORMER_B_ARCH, extra=m["EXTRA"],
        num_joints=m["NUM_JOINTS"], d_model=m["DIM_MODEL"],
        dim_feedforward=m["DIM_FEEDFORWARD"], n_head=m["N_HEAD"],
        encoder_layers=m["ENCODER_MULTI_LAYERS"], trans_size=tuple(m["TRANS_SIZE"]),
        heatmap_size=tuple(m["HEATMAP_SIZE"]), inter_supervision=m["INTER_SUPERVISION"],
        singleformer_fix=m["SINGLEFORMER_FIX"],
        frozen_stage_eval=dev.get("FROZEN_STAGE_EVAL_MODE", False),
        remat=dev.get("REMAT", False), compute_dtype=DTYPES[dev["COMPUTE_DTYPE"]])
    model.set_kernels(dev["USE_KERNELS"] if use_kernels is None else use_kernels,
                      dev.get("FUSED_BLOCK_EVAL", True), dev.get("FUSED_MLP_EVAL", False),
                      dev.get("FUSED_BLOCK_TRAIN", False),
                      dev.get("FUSED_BLOCK_EVAL_ONEPASS", False))
    set_train_routes(model.multi_global_encoder, dev)
    return model.to(device).eval()


def build_model(cfg: Dict, use_kernels: Optional[bool] = None, device="cuda"):
    """The ported model of ``MODEL.NAME`` (``interformer_pureMulti`` or
    ``interformer``) on ``device`` (the card unless asked), in eval mode."""
    name = cfg["MODEL"]["NAME"]
    if name == "interformer_pureMulti":
        return build_pure_multi(cfg, use_kernels, device)
    if name == "interformer":
        return build_interformer(cfg, use_kernels, device)
    raise ValueError(f"model {name!r} is not ported")
