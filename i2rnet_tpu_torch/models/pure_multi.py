"""Vanilla I²R-Net (``interformer_pureMulti``).

Port of ``i2rnet_tpu/models/pure_multi.py``: HRNet-W48-S trunk, a 1x1
reduce, the conv position embedding (none under ``USE_MULTI_POS`` false, as
the OCHuman recipe sets: the encoder then takes no ``pos``), one
inter-human transformer encoder over all persons' tokens of an image, one
deconv block applied twice (shared weights, faithful to the reference
quirk), a 1x1 heatmap head, and padded persons' heatmaps zeroed. The state-dict names are the original PyTorch
repo's, so ``convert_state_dict(model.state_dict(), "interformer_pureMulti")``
gives the JAX variable tree. :func:`init_weights` is the JAX package's
initialisation of this model and of the HRFormer two-stage model (convs
N(0, 0.001), dense layers Xavier-uniform, BN/LN 1 and 0).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from i2rnet_tpu_torch.models.encoder import (SelfAttention, TransformerEncoder, WindowAttention,
                                             flatten_person_tokens)
from i2rnet_tpu_torch.models.hrformer import WindowRPEAttention
from i2rnet_tpu_torch.models.hrnet import HRNetTrunk
from i2rnet_tpu_torch.models.layers import (Conv2d, DeconvBlock, conv_init_, remat_layers,
                                            training_call)
from i2rnet_tpu_torch.models.position import PositionEmbeddingImage

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RPE_INIT_STD = 0.02  # flax truncated_normal(0.02): the untruncated std, cut at +-2 std


class PureMultiInterFormer(HRNetTrunk):
    """``forward(images [B,N,H,W,3], pos_masks [B,N,H,W,1], person_valid [B,N])
    -> heatmaps [B, N, K, hh, hw]`` (float32), as the JAX model's ``"multi"``.

    ``global_encoder.use_kernels`` routes the encoder through the kernels
    (eval A and B, training C and D) or their plain versions;
    ``compute_dtype`` is the activation dtype (``TPU.COMPUTE_DTYPE``).

    ``train=True`` is the JAX ``train=True``: the modules run in training
    mode for this call (restored after), every BatchNorm normalises over the
    valid persons (``person_valid`` set as each BN's ``person_mask`` for the
    call: trunk, position embedding and both applications of the deconv
    block), and the encoder's dropout is keyed by ``dropout_seed``.
    ``remat`` is ``DEVICE.REMAT``: ``layers`` (or True) recomputes each
    encoder layer in the backward, as the JAX builder's ``nn.remat``; the
    step recomputes under ``dots`` and ``full`` (``core/train.py``); an
    unknown value raises here."""

    def __init__(self, extra: Dict, num_joints: int = 17, d_model: int = 96,
                 dim_feedforward: int = 192, n_head: int = 1, encoder_layers: int = 6,
                 trans_size=(16, 12), use_multi_pos: bool = True,
                 multi_pos_mode: str = "conv", final_conv_kernel: int = 1,
                 use_kernels: bool = False, remat=False, compute_dtype: torch.dtype = torch.float32):
        super().__init__(extra)
        self.trans_size = tuple(trans_size)
        self.d_model = d_model
        self.compute_dtype = compute_dtype
        self.reduce = Conv2d(self.trunk_channels[-1], d_model, 1, bias=False)
        self.position_embedding = (PositionEmbeddingImage(trans_size, d_model, multi_pos_mode)
                                   if use_multi_pos else None)
        self.global_encoder = TransformerEncoder(encoder_layers, d_model, n_head,
                                                 dim_feedforward, use_kernels,
                                                 remat=remat_layers(remat))
        filters = extra["NUM_DECONV_FILTERS"][0]
        self.deconv_layers = DeconvBlock(d_model, filters, extra["NUM_DECONV_KERNELS"][0],
                                         bias=extra.get("DECONV_WITH_BIAS", False))
        self.final_layer = Conv2d(filters, num_joints, final_conv_kernel, 1,
                                  final_conv_kernel // 2)

    def set_kernels(self, use_kernels: bool) -> None:
        """``DEVICE.USE_KERNELS``: Kernels A and B (C and D in training)."""
        self.global_encoder.use_kernels = use_kernels

    def encoders(self):
        """The transformer encoders whose layers run Kernels A and B."""
        return [self.global_encoder]

    def forward(self, images, pos_masks, person_valid, train: bool = False,
                dropout_seed: Optional[int] = None):
        with training_call(self, train, person_valid):
            return self._forward(images, pos_masks, person_valid, dropout_seed)

    def _forward(self, images, pos_masks, person_valid, dropout_seed):
        b, n, h, w, _ = images.shape
        th, tw = self.trans_size
        dt = self.compute_dtype
        x = images.reshape(b * n, h, w, 3).permute(0, 3, 1, 2).to(dt)
        feat = self.reduce(self.forward_trunk(x)[-1])            # [B*N, C, th, tw]
        tokens = feat.permute(0, 2, 3, 1).reshape(b, n * th * tw, self.d_model)
        pos = None
        if self.position_embedding is not None:
            pos = flatten_person_tokens(self.position_embedding(pos_masks.to(dt))).to(dt)
        key_pad = (~person_valid).repeat_interleave(th * tw, dim=1)
        out = self.global_encoder(tokens, key_pad, pos, dropout_seed)
        out = out.reshape(b * n, th, tw, self.d_model).permute(0, 3, 1, 2)
        out = self.deconv_layers(self.deconv_layers(out))
        heat = self.final_layer(out)
        heat = heat.reshape(b, n, *heat.shape[1:])
        heat = heat * person_valid[:, :, None, None, None].to(heat.dtype)
        return heat.float()


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX package's initialisation of either ported model, in place, from
    ``generator``: every convolution (and the deconvs) N(0, 0.001) with zero
    bias (``conv_init``, reference ``init_weights``); every dense layer
    Xavier-uniform with zero bias (``nn.Dense(kernel_init=xavier)``: the
    encoder's q, k, v as three [C, C] matrices, as the JAX ``q_proj``/
    ``k_proj``/``v_proj``, and the HRFormer's window-attention projections);
    the HRFormer's and the window inter encoder's relative-position tables
    truncated normal, std 0.02 cut at 2 std (``rpe_table``); TransPose-H's and the end-to-end model's
    learnable position embeddings N(0, 1); BatchNorm and LayerNorm scale 1, bias 0; running statistics 0
    and 1."""
    with torch.no_grad():
        for m in model.modules():
            for name in ("pos_embedding", "single_pos_embedding"):  # learnable tables
                if isinstance(getattr(m, name, None), nn.Parameter):
                    getattr(m, name).normal_(0.0, 1.0, generator=generator)
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                conv_init_(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.zero_()
            elif isinstance(m, SelfAttention):
                for part in m.in_proj_weight.chunk(3, dim=0):
                    nn.init.xavier_uniform_(part, generator=generator)
                m.in_proj_bias.zero_()
            if isinstance(m, (WindowRPEAttention, WindowAttention)):
                nn.init.trunc_normal_(m.relative_position_bias_table, std=RPE_INIT_STD,
                                      a=-2 * RPE_INIT_STD, b=2 * RPE_INIT_STD,
                                      generator=generator)
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm2d):
                    m.reset_running_stats()
    return model


def build_pure_multi(cfg: Dict, use_kernels=None, device="cuda") -> PureMultiInterFormer:
    """The model from a port config (``presets``), in eval mode, on ``device``
    (the card unless the caller names another; without CUDA that raises).
    ``use_kernels`` defaults to ``cfg["DEVICE"]["USE_KERNELS"]``
    (``TPU.USE_PALLAS_ATTENTION``); ``FLASH_TRAIN_ATTENTION`` and
    ``FUSED_FFN_TRAIN`` set the encoder's training routes, ``REMAT`` its
    recomputation (an unknown value raises)."""
    m = cfg["MODEL"]
    if m["NAME"] != "interformer_pureMulti":
        raise ValueError(f"model {m['NAME']!r} is not ported")
    dev = cfg["DEVICE"]
    model = PureMultiInterFormer(
        extra=m["EXTRA"], num_joints=m["NUM_JOINTS"], d_model=m["DIM_MODEL"],
        dim_feedforward=m["DIM_FEEDFORWARD"], n_head=m["N_HEAD"],
        encoder_layers=m["ENCODER_LAYERS"], trans_size=tuple(m["TRANS_SIZE"]),
        use_multi_pos=m.get("USE_MULTI_POS", True), multi_pos_mode=m["MULTI_POS_EMBEDDING"],
        final_conv_kernel=m["EXTRA"].get("FINAL_CONV_KERNEL", 1),
        use_kernels=dev["USE_KERNELS"] if use_kernels is None else use_kernels,
        remat=dev.get("REMAT", False), compute_dtype=DTYPES[dev["COMPUTE_DTYPE"]])
    set_train_routes(model.global_encoder, dev)
    return model.to(device).eval()


def set_train_routes(encoder: TransformerEncoder, dev: Dict) -> None:
    """The encoder's training routes from ``DEVICE``: Kernel C on
    ``FLASH_TRAIN_ATTENTION``, Kernel D on ``FUSED_FFN_TRAIN`` (each where
    ``use_kernels`` is on too; both on by default, as the JAX config)."""
    encoder.flash_train = bool(dev.get("FLASH_TRAIN_ATTENTION", True))
    encoder.fused_ffn_train = bool(dev.get("FUSED_FFN_TRAIN", True))
