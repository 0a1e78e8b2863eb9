"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper has a plain PyTorch version in its own module.  Dispatch is by
the device of the input alone: a CPU tensor takes the plain version; a CUDA
tensor launches the kernel, or the wrapper raises.  Each wrapper counts its
launches by compute dtype in ``launches_by_dtype``, one added where it
launches its kernel and nowhere else (K2-K4 launch their f32 or bf16 kernel;
K1 and K1-bwd are f32 only).
"""

from __future__ import annotations

from singlehdr_tpu_torch.ops.cuda.apply_rf_cuda import apply_rf, apply_rf_bwd
from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2
from singlehdr_tpu_torch.ops.cuda.lin_stem_cuda import lin_feature_stem
from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2

# name -> wrapper, in pipeline order; the backward last
KERNELS = {
    "apply_rf": apply_rf,
    "unet_stage2": unet_stage2,
    "lin_feature_stem": lin_feature_stem,
    "encoder_stage2": encoder_stage2,
    "apply_rf_bwd": apply_rf_bwd,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches_by_dtype = {}


def launch_counts() -> dict:
    """{kernel: launches in every dtype}."""
    return {name: sum(fn.launches_by_dtype.values()) for name, fn in KERNELS.items()}


def launch_counts_by_dtype() -> dict:
    """{kernel: {"float32": n, "bfloat16": m}} (only the dtypes launched)."""
    return {name: dict(fn.launches_by_dtype) for name, fn in KERNELS.items()}


__all__ = [
    "KERNELS",
    "apply_rf",
    "apply_rf_bwd",
    "encoder_stage2",
    "launch_counts",
    "launch_counts_by_dtype",
    "lin_feature_stem",
    "reset_launches",
    "unet_stage2",
]
