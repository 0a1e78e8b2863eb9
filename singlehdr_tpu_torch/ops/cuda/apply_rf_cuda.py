"""K1: per-sample 1-D LUT application (``apply_rf``), forward and backward.

Forward: replaces ``singlehdr_tpu/ops/pallas/apply_rf_pallas.py``
(``_apply_rf_core`` / ``_kernel``), which recast the gather as one-hot
matmuls because the TPU has no per-lane gather.  Here each block stages its
sample's curve in shared memory once and gathers from it directly while it
streams a long run of the sample's pixels in float4s (``csrc/apply_rf.cu``);
the grid is sized to the card (``blocks_per_sample``).  Bound by device
memory: 8 bytes a pixel.  The forward is bit-identical to ``apply_rf_plain``:
the kernel rounds every operation as the plain version does (no FMA).

Backward (K1-bwd): replaces ``_core_bwd`` / ``_bwd_kernel`` of the same file,
which scattered the curve gradient through one-hot MXU contractions.  Here
it streams x and g on the forward's grid and block -> pixel map; each warp
adds its pixels' lerp weights into its own k-bin histogram in shared memory,
the lanes of one bin summed first, so that no two lanes add to one bin at
once and the bins need no atomics (pixels with i0 == i1, in bins 0 and k - 1,
are summed in registers).  Each block stores its warps' sum as one row of a
``[b, bps, k]`` scratch, and a second launch sums the rows in a fixed order
into ``grf``.  ``gx`` is bit-identical to ``apply_rf_bwd_plain``; ``grf``
sums in another, fixed order, so it is bit-identical from run to run.

``apply_rf`` is differentiable (``ApplyRf``): a CPU tensor takes the plain
versions, a CUDA tensor launches K1 and, under autograd, K1-bwd, or raises.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from singlehdr_tpu_torch.ops.cuda import _build
from singlehdr_tpu_torch.ops.cuda._check import count_launch, cuda_f32, ptr, require, stream


THREADS = 256     # csrc/apply_rf.cu kThreads
BLOCKS_PER_SM = 4  # K1's grid: about this many blocks on each SM, over all samples
MIN_PIXELS_PER_BLOCK = THREADS * 16
# csrc/apply_rf.cu kBwdMaxBins: K1-bwd keeps 8 warp histograms, the curve and
# 8 x k tag bytes in shared memory
BWD_MAX_BINS = 4096


def blocks_per_sample(b: int, n: int, sms: int) -> int:
    """K1's blocks for each of b samples of n pixels on a card with ``sms``
    SMs: enough to fill the card, few enough that each block's one curve
    staging is spread over at least 16 pixels a thread."""
    return max(1, min(-(-BLOCKS_PER_SM * sms // b), -(-n // MIN_PIXELS_PER_BLOCK)))


@functools.cache
def _sm_count(index: int | None) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _lerp_indices(x: torch.Tensor, k: int):
    """(frac, i0, i1) of the lerp over a k-sample curve; x is [b, n]."""
    y = x * (k - 1)
    y0 = torch.floor(y)
    frac = y - y0
    iy = y0.to(torch.int64)
    return frac, iy.clamp(0, k - 1), (iy + 1).clamp(0, k - 1)


def apply_rf_plain(x: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """Plain version: x [b, ...] in nominal [0, 1], rf [b, k] -> x's shape.

    y = (k-1) x; lerp between rf[clip(floor y)] and rf[clip(floor y + 1)]
    (the ceil index clamps floor+1, as in the reference's sample_1d).
    """
    b, k = rf.shape
    if x.shape[0] != b:
        raise ValueError(f"apply_rf: batch mismatch — x has batch {x.shape[0]}, rf has {b}")
    frac, i0, i1 = _lerp_indices(x.reshape(b, -1), k)
    v0 = torch.gather(rf, 1, i0)
    v1 = torch.gather(rf, 1, i1)
    return (v0 + frac * (v1 - v0)).reshape(x.shape)


def apply_rf_bwd_plain(x, rf, g, need_x: bool, need_rf: bool):
    """Plain backward of ``apply_rf_plain`` (the formulas of ``_bwd_kernel``):
    gx = (k-1)(v1-v0) g, and grf scatter-adds (1-frac) g into bin i0 and
    frac g into bin i1.  Returns (gx | None, grf | None)."""
    b, k = rf.shape
    frac, i0, i1 = _lerp_indices(x.reshape(b, -1), k)
    gf = g.reshape(b, -1)
    gx = grf = None
    if need_x:
        v0 = torch.gather(rf, 1, i0)
        v1 = torch.gather(rf, 1, i1)
        gx = ((k - 1) * (v1 - v0) * gf).reshape(x.shape)
    if need_rf:
        grf = torch.zeros_like(rf)
        grf.scatter_add_(1, i0, (1 - frac) * gf)
        grf.scatter_add_(1, i1, frac * gf)
    return gx, grf


def _check_launch(name: str, x: torch.Tensor, rf: torch.Tensor) -> tuple:
    require(x.device.type == "cuda", f"{name}: no kernel for device {x.device}")
    return check_args(name, x, rf)


def check_args(name: str, x: torch.Tensor, rf: torch.Tensor) -> tuple:
    """K1's and K1-bwd's argument checks; returns (b, k).  Both are f32 in
    every compute dtype (the nets hand ``apply_rf`` f32), so a bf16 tensor
    here is a missed cast and raises."""
    cuda_f32(f"{name}: rf", rf, x.device, 2)
    require(x.dtype == torch.float32 and x.is_contiguous(), f"{name}: x must be contiguous float32")
    b, k = rf.shape
    require(x.dim() >= 1 and x.shape[0] == b,
            f"{name}: batch mismatch — x has shape {tuple(x.shape)}, rf has {b}")
    require(k >= 2, f"{name}: the curve needs at least 2 samples")
    return b, k


def _apply_rf_forward(x: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return apply_rf_plain(x, rf)
    b, k = _check_launch("apply_rf", x, rf)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    n = x.numel() // b
    with torch.cuda.device(x.device):
        _build.call(
            "shdr_apply_rf_f32", ptr(x), ptr(rf), ptr(out), b, n, k,
            blocks_per_sample(b, n, _sm_count(x.device.index)), stream(x.device),
        )
    count_launch(apply_rf)
    return out


def apply_rf_bwd(x, rf, g, need_x: bool, need_rf: bool):
    """K1-bwd wrapper: plain version on the CPU, the CUDA kernels on the GPU
    (the streaming kernel, then the sum of its per-block rows when grf is
    wanted; one launch count).  Returns (gx | None, grf | None); an unwanted
    gradient is not allocated."""
    if x.device.type == "cpu":
        return apply_rf_bwd_plain(x, rf, g, need_x, need_rf)
    b, k = _check_launch("apply_rf_bwd", x, rf)
    require(g.device == x.device and g.dtype == torch.float32 and g.is_contiguous()
            and g.shape == x.shape,
            f"apply_rf_bwd: grad_output must be contiguous float32 {tuple(x.shape)} on {x.device}")
    require(k <= BWD_MAX_BINS,
            f"apply_rf_bwd: the kernel holds curves of at most {BWD_MAX_BINS} samples, got {k}")
    gx = torch.empty_like(x) if need_x else None
    grf = torch.empty_like(rf) if need_rf else None
    if not (need_x or need_rf):
        return gx, grf
    if x.numel() == 0:
        return gx, None if grf is None else grf.zero_()
    n = x.numel() // b
    bps = blocks_per_sample(b, n, _sm_count(x.device.index))
    partial = torch.empty(b, bps, k, device=x.device) if need_rf else None
    with torch.cuda.device(x.device):
        _build.call(
            "shdr_apply_rf_bwd_f32", ptr(x), ptr(rf), ptr(g),
            None if gx is None else ptr(gx), None if grf is None else ptr(grf),
            None if partial is None else ptr(partial), b, n, k, bps, stream(x.device),
        )
    count_launch(apply_rf_bwd)
    return gx, grf


class ApplyRf(torch.autograd.Function):
    """K1 forward, K1-bwd backward (``jax.custom_vjp`` of ``_apply_rf_core``)."""

    @staticmethod
    def forward(ctx, x, rf):
        ctx.save_for_backward(x, rf)
        return _apply_rf_forward(x, rf)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, rf = ctx.saved_tensors
        need_x, need_rf = ctx.needs_input_grad
        return apply_rf_bwd(x, rf, g.contiguous(), need_x, need_rf)


def apply_rf(x: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """K1 wrapper, differentiable in x and rf: plain versions on the CPU, the
    CUDA kernels on the GPU."""
    return ApplyRf.apply(x, rf)


apply_rf.launches_by_dtype = {}
apply_rf_bwd.launches_by_dtype = {}
