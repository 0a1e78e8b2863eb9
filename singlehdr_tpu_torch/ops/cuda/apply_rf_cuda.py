"""K1: per-sample 1-D LUT application (``apply_rf``), forward.

Replaces ``singlehdr_tpu/ops/pallas/apply_rf_pallas.py`` (``apply_rf_pallas``
/ ``_kernel``), which recast the gather as one-hot matmuls because the TPU
has no per-lane gather.  Here each block stages its sample's curve in shared
memory and gathers from it directly (``csrc/apply_rf.cu``).  Bound by device
memory: 8 bytes a pixel.  The forward is bit-identical to ``apply_rf_plain``:
the kernel rounds every operation as the plain version does (no FMA).
"""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.cuda import _build
from singlehdr_tpu_torch.ops.cuda._check import (
    cuda_f32,
    no_grad_needed,
    ptr,
    require,
    stream,
)


def apply_rf_plain(x: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """Plain version: x [b, ...] in nominal [0, 1], rf [b, k] -> x's shape.

    y = (k-1) x; lerp between rf[clip(floor y)] and rf[clip(floor y + 1)]
    (the ceil index clamps floor+1, as in the reference's sample_1d).
    """
    b, k = rf.shape
    if x.shape[0] != b:
        raise ValueError(f"apply_rf: batch mismatch — x has batch {x.shape[0]}, rf has {b}")
    y = x.reshape(b, -1) * (k - 1)
    y0 = torch.floor(y)
    frac = y - y0
    iy = y0.to(torch.int64)
    v0 = torch.gather(rf, 1, iy.clamp(0, k - 1))
    v1 = torch.gather(rf, 1, (iy + 1).clamp(0, k - 1))
    return (v0 + frac * (v1 - v0)).reshape(x.shape)


def apply_rf(x: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """K1 wrapper: plain version on the CPU, the CUDA kernel on the GPU."""
    if x.device.type == "cpu":
        return apply_rf_plain(x, rf)
    require(x.device.type == "cuda", f"apply_rf: no kernel for device {x.device}")
    cuda_f32("apply_rf: rf", rf, x.device, 2)
    require(x.dtype == torch.float32 and x.is_contiguous(),
            "apply_rf: x must be contiguous float32")
    b, k = rf.shape
    require(x.dim() >= 1 and x.shape[0] == b,
            f"apply_rf: batch mismatch — x has shape {tuple(x.shape)}, rf has {b}")
    require(k >= 2, "apply_rf: the curve needs at least 2 samples")
    no_grad_needed("apply_rf", x, rf)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    n = x.numel() // b
    with torch.cuda.device(x.device):
        _build.call(
            "shdr_apply_rf_f32", ptr(x), ptr(rf), ptr(out), b, n, k, stream(x.device)
        )
    apply_rf.launches += 1
    return out


apply_rf.launches = 0
