"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers and launch counts.

Each wrapper counts ``kernel.<name>`` in :mod:`i2rnet_tpu_torch.tracing` where it
launches its kernel (``<name>`` its key in :data:`KERNELS`), so a run can show
that its path went through the kernel; :func:`launch_counts` reads the counts,
recording or not. The training kernels count their forward and backward
launches apart.
Importing this package registers the eval kernels as ``i2r::`` ops
(:mod:`~i2rnet_tpu_torch.ops.cuda.library`), which exported programs call.
"""

from i2rnet_tpu_torch import tracing
from i2rnet_tpu_torch.ops.cuda.conv_epilogue import conv_epilogue_fused
from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused
from i2rnet_tpu_torch.ops.cuda.encoder_ffn_train import ffn_train_bwd, ffn_train_fwd
from i2rnet_tpu_torch.ops.cuda.hrformer_block import (full_block_fused, mlp_block_fused,
                                                      window_attn_block_fused)
from i2rnet_tpu_torch.ops.cuda.hrformer_block_train import (window_attn_train_bwd,
                                                            window_attn_train_fwd)
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused
from i2rnet_tpu_torch.ops.cuda.mhsa_train import mhsa_train_bwd, mhsa_train_fwd
from i2rnet_tpu_torch.ops.cuda.mlp_dwbn import mlp_dwbn_fused
from i2rnet_tpu_torch.ops.cuda import library  # noqa: F401  (registers the i2r:: ops)

KERNELS = {"masked_mhsa": masked_mhsa_fused, "encoder_ffn": encoder_ffn_fused,
           "mhsa_train_fwd": mhsa_train_fwd, "mhsa_train_bwd": mhsa_train_bwd,
           "encoder_ffn_train_fwd": ffn_train_fwd, "encoder_ffn_train_bwd": ffn_train_bwd,
           "window_attn_block": window_attn_block_fused, "mlp_block": mlp_block_fused,
           "mlp_dwbn": mlp_dwbn_fused, "window_attn_block_train_fwd": window_attn_train_fwd,
           "window_attn_block_train_bwd": window_attn_train_bwd, "full_block": full_block_fused,
           "conv_epilogue": conv_epilogue_fused}


def reset_launches() -> None:
    tracing.clear("kernel.")


def launch_counts() -> dict:
    return {name: tracing.total(f"kernel.{name}") for name in KERNELS}
