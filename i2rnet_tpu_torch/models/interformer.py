"""Two-stage I²R-Net (``interformer``, ``interformer_2stage``).

Port of ``i2rnet_tpu/models/interformer.py:76-231`` for the released
two-stage recipes: the HRFormer-B first stage
(``experiments/coco/interformer_coco_hrt_192_p2_b12.yaml``) and the
TransPose-H one (``interformer_coco_tph_192_p4_b4.yaml``):

* the first stage (``singleformer``: :class:`~.hrformer.HRFormer` or
  :class:`~.transpose_h.TransPoseH`, on ``MODEL.SINGLEFORMER``) runs per
  person on the flattened [B*N] axis -> (features, single heatmaps);
* the features are max-pooled (3x3/s2) floor(log2(W/4 / TRANS_W)) times; the
  pooled map is the token grid (64x48 -> 16x12 at 256x192);
* with ``USE_MULTI_POS`` the box-mask position embedding
  (``multi_position_embedding``, modes ``conv``/``res``/``sine``/``cat_vec``)
  on that grid;
* the inter encoder (``multi_global_encoder``, Kernels A and B with
  ``DEVICE.USE_KERNELS``) over all persons' tokens of an image, key-padding
  mask from ``person_valid``, the position embedding added to q and k; with
  ``MULTI_POS_EMBEDDING: cat_vec`` the embedding's vector
  (``MULTI_POS_EMBEDDING_DIM`` wide) is concatenated to the tokens instead,
  the encoder runs at ``DIM_MODEL + MULTI_POS_EMBEDDING_DIM`` channels (its
  kernels at that width: 192 on the TPH recipes, 174 on the HRT ones) with
  no position term, and a 1x1 conv ``fc`` brings its output back to
  ``DIM_MODEL`` (JAX ``interformer.py:168-181``); with ``ATTENTION_TYPE:
  window`` the inter encoder is :class:`~.encoder.WindowInterEncoder`;
* back to the heatmap size on ``UPSAMPLE_TYPE``: ``deconv`` (separate deconv
  blocks, ``upsample_layer.deconv_layers.{i}``), ``multiplex`` (one block
  applied each step, ``deconv_layers``) or ``upconv`` (:class:`UpConv`,
  ``upsample_layer``);
* the residual on the first-stage features (with ``DOMAIN_TRANS`` a 1x1 conv
  on each operand, ``domain_trans_{1,2}``), the 1x1 ``final_layer``, padded
  persons zeroed;
* returns ``{"single", "multi"}`` heatmaps ``[B, N, K, H/4, W/4]`` (f32;
  ``single`` None unless inter-supervision is on and the first stage trains).

Both model names build the same composition, as in the JAX package (its
``interformer_2stage`` builder reduces to it for the released configs). The
state-dict names are the main ``interformer``'s, so
``convert_state_dict(model.state_dict(), name)`` takes them under either name.

``forward(..., train=True, dropout_seed=...)`` is the JAX ``train=True`` as
:class:`~.pure_multi.PureMultiInterFormer` has it, with either first stage:
training mode for the call, every BatchNorm (first stage, deconvs) over the
valid persons, the HRFormer's DropPath and every encoder's dropout keyed by
the seed (the TransPose-H intra encoder and the inter encoder on disjoint
offsets, ``models/encoder.py``). With ``SINGLEFORMER_FIX`` the first stage
runs without autograd in a training forward (the JAX ``stop_gradient``;
``core/pretrained.py::freeze`` takes its parameters out of training), its
BatchNorm statistics still updating, and ``single`` is None; with
``DEVICE.FROZEN_STAGE_EVAL_MODE`` too it runs in eval mode (running
statistics, no dropout or DropPath, the eval kernels), as the JAX model
does. ``DEVICE.REMAT`` ``layers`` recomputes each encoder layer (intra and
inter) and each HRFormer block in the backward, as the JAX builders pass
``remat`` down; ``dots`` and ``full`` recompute at the step
(``core/train.py``); an unknown value raises when the model is built.

:func:`build_model` builds every ported model from a port config, on the card
unless asked otherwise.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from i2rnet_tpu_torch.models.encoder import (TransformerEncoder, WindowInterEncoder,
                                             flatten_person_tokens)
from i2rnet_tpu_torch.models.hrformer import HRFORMER_B_ARCH, HRFormer
from i2rnet_tpu_torch.models.layers import (Conv2d, ConvBN, DeconvBlock, MaskedBatchNorm,
                                            max_pool_3x3_s2, remat_layers, training_call,
                                            upsample_nearest)
from i2rnet_tpu_torch.models.position import PositionEmbeddingImage
from i2rnet_tpu_torch.models.pure_multi import DTYPES, build_pure_multi, set_train_routes
from i2rnet_tpu_torch.models.transpose_h import TransPoseH

#: the model names this module builds, and the first stages it ports
TWO_STAGE_NAMES = ("interformer", "interformer_2stage")
FIRST_STAGES = ("hrformer", "transpose_h")
#: MODEL.UPSAMPLE_TYPE values ported
UPSAMPLE_TYPES = ("deconv", "multiplex", "upconv")
#: MODEL.ATTENTION_TYPE values (reference attention.py:1054)
ATTENTION_TYPES = ("default", "window")


class DeconvUpsample(nn.Module):
    """The reference ``DeConv`` wrapper: ``steps`` separate deconv blocks."""

    def __init__(self, cin: int, filters: int, kernel: int, steps: int, bias: bool):
        super().__init__()
        self.deconv_layers = nn.Sequential(*[
            DeconvBlock(cin if i == 0 else filters, filters, kernel, bias) for i in range(steps)])

    def forward(self, x):
        return self.deconv_layers(x)


class UpConv(nn.Module):
    """1x1 ConvBN, nearest upsampling by ``scale``, two 3x3 ConvBN + ReLU
    (the JAX ``UpConv``, reference ``interformer.py:25-64``)."""

    def __init__(self, d_model: int, scale: int):
        super().__init__()
        self.scale = scale
        self.fuse = ConvBN(d_model, d_model, 1, relu=False)
        self.conv1 = ConvBN(d_model, d_model, 3)
        self.conv2 = ConvBN(d_model, d_model, 3)

    def forward(self, x):
        return self.conv2(self.conv1(upsample_nearest(self.fuse(x), self.scale)))


class InterFormer(nn.Module):
    """``forward(images [B,N,H,W,3], pos_masks [B,N,H,W,1], person_valid [B,N],
    train=False, dropout_seed=None) -> {"single", "multi"}`` (``pos_masks``
    unused without ``use_multi_pos``). ``singleformer`` is the first stage,
    :class:`~.hrformer.HRFormer` or :class:`~.transpose_h.TransPoseH`.
    ``compute_dtype`` is ``DEVICE.COMPUTE_DTYPE``; :meth:`set_kernels` switches
    every kernel route at once."""

    def __init__(self, singleformer: nn.Module, extra: Dict, num_joints: int = 17,
                 d_model: int = 78, dim_feedforward: int = 192, n_head: int = 1,
                 encoder_layers: int = 2, trans_size=(16, 12), heatmap_size=(48, 64),
                 use_multi_pos: bool = False, multi_pos_mode: str = "conv",
                 multi_pos_dim: int = 96, attention_type: str = "default",
                 window_size: int = 7, upsample_type: str = "deconv", domain_trans: bool = False,
                 inter_supervision: bool = True, singleformer_fix: bool = False,
                 frozen_stage_eval: bool = False, remat=False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.trans_size = tuple(trans_size)
        self.d_model = d_model
        self.compute_dtype = compute_dtype
        self.upsample_type = upsample_type
        self.return_single = inter_supervision and not singleformer_fix
        self.singleformer_fix = singleformer_fix
        self.frozen_stage_eval = frozen_stage_eval
        self.singleformer = singleformer
        layers = remat_layers(remat)
        singleformer.set_remat(layers)
        # the token grid, as the JAX model reads it off the pooled map (3x3/s2
        # pools with padding 1 take w to ceil(w / 2))
        th, tw = heatmap_size[1], heatmap_size[0]
        for _ in range(int(math.log2(heatmap_size[0] // self.trans_size[1]))):
            th, tw = (th + 1) // 2, (tw + 1) // 2
        if use_multi_pos:
            self.multi_position_embedding = PositionEmbeddingImage((th, tw), d_model,
                                                                   multi_pos_mode, multi_pos_dim)
        else:
            self.multi_position_embedding = None
        # cat_vec: the vector joins the channels, the encoder runs wider, fc comes back
        self.cat_vec = use_multi_pos and multi_pos_mode == "cat_vec"
        width = d_model + multi_pos_dim if self.cat_vec else d_model
        if attention_type == "window":
            self.multi_global_encoder = WindowInterEncoder(width, n_head, window_size)
        else:
            self.multi_global_encoder = TransformerEncoder(encoder_layers, width, n_head,
                                                           dim_feedforward, remat=layers)
        if self.cat_vec:
            self.fc = Conv2d(width, d_model, 1)
        taken = [o for e in singleformer.encoders() for o in e.offsets()]
        if set(taken) & set(self.multi_global_encoder.offsets()):
            raise ValueError(f"{encoder_layers} inter layers take dropout offsets of the "
                             "first stage's encoder")
        steps = int(math.log2(heatmap_size[0] // tw))
        filters = extra["NUM_DECONV_FILTERS"][0]
        kernel, bias = extra["NUM_DECONV_KERNELS"][0], extra.get("DECONV_WITH_BIAS", False)
        self.up_steps = steps
        if upsample_type == "deconv":
            self.upsample_layer = DeconvUpsample(d_model, filters, kernel, steps, bias)
        elif upsample_type == "multiplex":  # ONE block applied each step (shared weights)
            self.deconv_layers = DeconvBlock(d_model, filters, kernel, bias)
        else:
            self.upsample_layer = UpConv(d_model, 2 ** steps)
            filters = d_model
        if domain_trans:
            self.domain_trans_1 = Conv2d(d_model, d_model, 1)
            self.domain_trans_2 = Conv2d(filters, d_model, 1)
            filters = d_model
        self.domain_trans = domain_trans
        k = extra.get("FINAL_CONV_KERNEL", 1)
        self.final_layer = Conv2d(filters, num_joints, k, 1, k // 2)

    def set_kernels(self, use_kernels: bool, fused_block: bool = True,
                    fused_mlp: bool = False, fused_train: bool = False,
                    fused_onepass: bool = False) -> None:
        """``DEVICE.USE_KERNELS`` (all routes: the encoders' Kernels A and B,
        C and D in training), and for the HRFormer first stage
        ``FUSED_BLOCK_EVAL`` (Kernels E + F), ``FUSED_MLP_EVAL`` (Kernel G,
        where E + F are off), ``FUSED_BLOCK_TRAIN`` (kernel 9 in training) and
        ``FUSED_BLOCK_EVAL_ONEPASS`` (kernel 7 in place of E + F)."""
        self.multi_global_encoder.use_kernels = use_kernels
        self.singleformer.set_routes(use_kernels, fused_block, fused_mlp, fused_train,
                                     fused_onepass)

    def encoders(self):
        """The transformer encoders whose layers run Kernels A and B (C and D
        in training): the TransPose-H intra encoder (where that is the first
        stage), then the inter encoder."""
        return self.singleformer.encoders() + [self.multi_global_encoder]

    def forward(self, images, pos_masks, person_valid, train: bool = False,
                dropout_seed: Optional[int] = None, drop_path_scales=None):
        with training_call(self, train, person_valid):
            return self._forward(images, pos_masks, person_valid, dropout_seed,
                                 drop_path_scales)

    def _first_stage(self, x, dropout_seed, drop_path_scales):
        """The first stage; frozen (``SINGLEFORMER_FIX``) in training, without
        autograd, and in eval mode under ``FROZEN_STAGE_EVAL_MODE``."""
        stage = self.singleformer
        if not (self.singleformer_fix and stage.training):
            return stage(x, dropout_seed, drop_path_scales)
        if not self.frozen_stage_eval:
            with torch.no_grad():
                return stage(x, dropout_seed, drop_path_scales)
        bns = [m for m in stage.modules() if isinstance(m, MaskedBatchNorm)]
        masks = [bn.person_mask for bn in bns]
        stage.eval()
        for bn in bns:
            bn.person_mask = None
        try:
            with torch.no_grad():
                return stage(x)
        finally:
            stage.train()
            for bn, mask in zip(bns, masks):
                bn.person_mask = mask

    def _forward(self, images, pos_masks, person_valid, dropout_seed, drop_path_scales):
        b, n, h, w, _ = images.shape
        x = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2).to(self.compute_dtype)
        feat, single_heat = self._first_stage(x, dropout_seed, drop_path_scales)
        single_res = feat
        for _ in range(int(math.log2(feat.shape[3] // self.trans_size[1]))):
            feat = max_pool_3x3_s2(feat)
        th, tw = feat.shape[2], feat.shape[3]
        tokens = feat.permute(0, 2, 3, 1).reshape(b, n * th * tw, self.d_model)
        key_pad = (~person_valid).repeat_interleave(th * tw, dim=1)
        pos = None
        if self.multi_position_embedding is not None:
            pos = flatten_person_tokens(self.multi_position_embedding(
                pos_masks.to(self.compute_dtype))).to(tokens.dtype)
        if self.cat_vec:
            tokens, pos = torch.cat([tokens, pos], dim=-1), None
        out = self.multi_global_encoder(tokens, key_pad, pos, dropout_seed)
        out = out.reshape(b * n, th, tw, out.shape[-1]).permute(0, 3, 1, 2)
        if self.cat_vec:
            out = self.fc(out)
        if self.upsample_type == "multiplex":
            for _ in range(self.up_steps):
                out = self.deconv_layers(out)
        else:
            out = self.upsample_layer(out)
        if self.domain_trans:
            out = self.domain_trans_1(single_res) + self.domain_trans_2(out)
        else:
            out = single_res + out
        heat = self.final_layer(out)
        vmask = person_valid[:, :, None, None, None]
        heat = heat.reshape(b, n, *heat.shape[1:])
        multi = (heat * vmask.to(heat.dtype)).float()
        single = None
        if self.return_single:
            single = (single_heat.reshape(b, n, *single_heat.shape[1:]) * vmask.float()).float()
        return {"single": single, "multi": multi}


def build_singleformer(cfg: Dict) -> nn.Module:
    """The first stage of ``MODEL.SINGLEFORMER``: HRFormer (``HRFORMER_ARCH``,
    HRFormer-B when absent) or TransPose-H."""
    m = cfg["MODEL"]
    name = m.get("SINGLEFORMER")
    if name == "hrformer":
        return HRFormer(m.get("HRFORMER_ARCH") or HRFORMER_B_ARCH, m["NUM_JOINTS"])
    if name == "transpose_h":
        return TransPoseH(
            m["EXTRA"], m["NUM_JOINTS"], m["DIM_MODEL"], m["DIM_FEEDFORWARD"], m["N_HEAD"],
            m["ENCODER_LAYERS"], tuple(m["IMAGE_SIZE"]), m.get("POS_EMBEDDING", "sine"),
            m.get("HRNET_RES_LAYER", 0), m["EXTRA"].get("FINAL_CONV_KERNEL", 1),
            m.get("PE_ONLY_AT_BEGIN", False))
    raise NotImplementedError(f"MODEL.SINGLEFORMER={name!r}: only {FIRST_STAGES} are ported")


def build_transpose_h(cfg: Dict, use_kernels: Optional[bool] = None, device="cuda") -> nn.Module:
    """The standalone TransPose-H single-person model (``MODEL.NAME``
    ``transpose_h``, or its legacy alias ``transpose_h_old``; the JAX
    ``models/transpose_h.py:89-92``): the first stage of
    :func:`build_singleformer` from the same ``MODEL`` keys, its encoder on
    the kernels where ``use_kernels`` (``DEVICE.USE_KERNELS``), in eval mode
    on ``device``. ``forward(x [P, 3, H, W])`` in the compute dtype returns
    (features, heatmaps)."""
    model = build_singleformer({**cfg, "MODEL": {**cfg["MODEL"], "SINGLEFORMER": "transpose_h"}})
    dev = cfg["DEVICE"]
    model.set_routes(dev["USE_KERNELS"] if use_kernels is None else use_kernels)
    model.set_remat(remat_layers(dev.get("REMAT", False)))
    set_train_routes(model.global_encoder, dev)
    return model.to(device).eval()


def build_interformer(cfg: Dict, use_kernels: Optional[bool] = None,
                      device="cuda") -> InterFormer:
    """The two-stage model from a port config, in eval mode, on ``device``.
    ``use_kernels`` defaults to ``DEVICE.USE_KERNELS``."""
    m, dev = cfg["MODEL"], cfg["DEVICE"]
    attention = m.get("ATTENTION_TYPE", "default")
    if attention not in ATTENTION_TYPES:
        raise ValueError(f"MODEL.ATTENTION_TYPE={attention!r}: expected one of {ATTENTION_TYPES}")
    upsample = m.get("UPSAMPLE_TYPE", "deconv")
    if upsample not in UPSAMPLE_TYPES:
        raise ValueError(f"MODEL.UPSAMPLE_TYPE={upsample!r}: expected one of {UPSAMPLE_TYPES}")
    model = InterFormer(
        build_singleformer(cfg), extra=m["EXTRA"], num_joints=m["NUM_JOINTS"],
        d_model=m["DIM_MODEL"], dim_feedforward=m["DIM_FEEDFORWARD"], n_head=m["N_HEAD"],
        encoder_layers=m["ENCODER_MULTI_LAYERS"], trans_size=tuple(m["TRANS_SIZE"]),
        heatmap_size=tuple(m["HEATMAP_SIZE"]), use_multi_pos=m.get("USE_MULTI_POS", False),
        multi_pos_mode=m.get("MULTI_POS_EMBEDDING", "conv"),
        # the default tree's 96 and 4 where a preset leaves these keys empty
        multi_pos_dim=m.get("MULTI_POS_EMBEDDING_DIM") or 96, attention_type=attention,
        window_size=m.get("WINDOW_SIZE") or 4, upsample_type=upsample,
        domain_trans=m.get("DOMAIN_TRANS", False), inter_supervision=m["INTER_SUPERVISION"],
        singleformer_fix=m["SINGLEFORMER_FIX"],
        frozen_stage_eval=dev.get("FROZEN_STAGE_EVAL_MODE", False),
        remat=dev.get("REMAT", False), compute_dtype=DTYPES[dev["COMPUTE_DTYPE"]])
    model.set_kernels(dev["USE_KERNELS"] if use_kernels is None else use_kernels,
                      dev.get("FUSED_BLOCK_EVAL", True), dev.get("FUSED_MLP_EVAL", False),
                      dev.get("FUSED_BLOCK_TRAIN", False),
                      dev.get("FUSED_BLOCK_EVAL_ONEPASS", False))
    for encoder in model.encoders():
        set_train_routes(encoder, dev)
    return model.to(device).eval()


def build_model(cfg: Dict, use_kernels: Optional[bool] = None, device="cuda"):
    """The ported model of ``MODEL.NAME`` (``interformer_pureMulti``,
    ``interformer``, ``interformer_2stage``, the end-to-end
    ``interformer_e2e`` and ``interformer_e2e_new``, or the standalone
    ``transpose_h``)
    on ``device`` (the card unless asked), in eval mode."""
    from i2rnet_tpu_torch.models.interformer_e2e import E2E_BUILDERS

    name = cfg["MODEL"]["NAME"]
    if name == "interformer_pureMulti":
        return build_pure_multi(cfg, use_kernels, device)
    if name in E2E_BUILDERS:
        return E2E_BUILDERS[name](cfg, use_kernels, device)
    if name in TWO_STAGE_NAMES:
        return build_interformer(cfg, use_kernels, device)
    if name in ("transpose_h", "transpose_h_old"):
        return build_transpose_h(cfg, use_kernels, device)
    raise ValueError(f"model {name!r} is not ported")
