"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers and launch counts.

Each wrapper keeps a plain integer ``launches`` that it raises by one where it
launches its kernel, so a run can show that its path went through the kernel.
"""

from i2rnet_tpu_torch.ops.cuda.encoder_ffn import encoder_ffn_fused
from i2rnet_tpu_torch.ops.cuda.mhsa import masked_mhsa_fused

KERNELS = {"masked_mhsa": masked_mhsa_fused, "encoder_ffn": encoder_ffn_fused}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
