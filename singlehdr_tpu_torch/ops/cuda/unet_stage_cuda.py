"""K2: fused U-Net encoder stage — leaky-ReLU SAME conv x2 + 2x2 average pool.

Replaces ``singlehdr_tpu/ops/pallas/unet_stage_pallas.py`` (``unet_stage2``),
which ran the deq/ref encoder prefix (stem pair, down2, down3) with the conv1
activation kept in VMEM.  On the card a stage is two launches of one implicit
GEMM conv on the tensor cores (``csrc/conv2_pool.cu``, launched through
``conv_gemm``): conv1 stores its activation, conv2 stores the skip and the
complete 2x2 pool from registers.  f32 tensors run in 3xTF32 (bound by the
f32-accurate multiply-adds at 165 TFLOP/s); bf16 tensors (x, w1, w2 bf16,
biases f32) in one bf16 product with f32 accumulation (989 TFLOP/s, where the
HBM traffic of mid, skip and pool comes close).  conv1's activation costs a
write and a read of HBM; in bf16 it is stored channel-blocked
(``conv_gemm.mid_like``), which conv2 stages with 16-byte copies.

The bf16 stage rounds where the Pallas kernel rounds: conv1's activation to
bf16 before conv2 reads it, the skip to bf16, and the average pool taken from
conv2's f32 values before one rounding (the JAX package's ``_xla_reference``
pools the rounded skip instead: at most one bf16 ulp of the pooled value).  The TPU's lane-alignment gates
(W % 128) do not apply: any H, W runs, including the 576^2 serving shape.

Layout: NCHW activations, OIHW weights (the port's own), as the JAX function
under ``nchw_in=True`` returns.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.ops.cuda import conv_gemm
from singlehdr_tpu_torch.ops.cuda._check import (
    conv_dtype,
    count_launch,
    cuda_tensor,
    no_grad_needed,
    require,
)

LEAKY_SLOPE = 0.1
KERNEL_SIZES = (3, 5, 7)


def unet_stage2_plain(x, w1, b1, w2, b2):
    """Plain version: ``(avg_pool_2x2(act), act)`` with
    ``act = lrelu(conv(lrelu(conv(x, w1) + b1), w2) + b2)``, SAME padding.
    For bf16 x, w1, w2 (f32 biases) it computes what the bf16 kernel computes:
    each conv in f32 on the bf16 values (exact products, as on the tensor
    cores), conv1's activation rounded to bf16, the skip rounded, and the
    pool taken from conv2's f32 values, then rounded.  On the card it needs
    TF32 off (``precision.use_full_f32``)."""
    pad = w1.shape[-1] // 2
    if x.dtype == torch.bfloat16:
        mid = F.leaky_relu(F.conv2d(x.float(), w1.float(), b1, padding=pad), LEAKY_SLOPE)
        y = F.leaky_relu(F.conv2d(mid.to(x.dtype).float(), w2.float(), b2, padding=pad),
                         LEAKY_SLOPE)
        return F.avg_pool2d(y, 2).to(x.dtype), y.to(x.dtype)
    y = F.leaky_relu(F.conv2d(x, w1, b1, padding=pad), LEAKY_SLOPE)
    y = F.leaky_relu(F.conv2d(y, w2, b2, padding=pad), LEAKY_SLOPE)
    return F.avg_pool2d(y, 2), y


def check_stage(name, x, w1, b1, w2, b2, kernel_sizes):
    """Shared K2/K4 argument checks; returns (B, C, H, W, F, K).  x, w1, w2 in
    one compute dtype (f32 or bf16), the biases f32."""
    dev = x.device
    dtype = conv_dtype(name, x)
    cuda_tensor(f"{name}: x", x, dev, 4, dtype)
    for arg, t, nd, dt in (("w1", w1, 4, dtype), ("b1", b1, 1, torch.float32),
                           ("w2", w2, 4, dtype), ("b2", b2, 1, torch.float32)):
        cuda_tensor(f"{name}: {arg}", t, dev, nd, dt)
    B, C, H, W = x.shape
    Fo, K = w1.shape[0], w1.shape[-1]
    require(K in kernel_sizes, f"{name}: kernel size {K} not in {kernel_sizes}")
    require(tuple(w1.shape) == (Fo, C, K, K), f"{name}: w1 {tuple(w1.shape)} != {(Fo, C, K, K)}")
    require(tuple(w2.shape) == (Fo, Fo, K, K), f"{name}: w2 {tuple(w2.shape)} != {(Fo, Fo, K, K)}")
    require(b1.shape == (Fo,) and b2.shape == (Fo,), f"{name}: biases must be [{Fo}]")
    for cin in (C, Fo):
        why = conv_gemm.supported(cin, Fo, K, dtype)
        require(why is None, f"{name}: {why}")
    require(H > 0 and W > 0 and B > 0, f"{name}: empty input {tuple(x.shape)}")
    no_grad_needed(name, x, w1, b1, w2, b2)
    return B, C, H, W, Fo, K


def unet_stage2(x, w1, b1, w2, b2):
    """K2 wrapper: ``(pooled [B,F,H/2,W/2], act [B,F,H,W])``.

    x [B, C, H, W]; w1 [F, C, K, K]; b1 [F]; w2 [F, F, K, K]; b2 [F];
    K in {3, 5, 7}; x, w1, w2 f32 or bf16, biases f32; outputs in x's dtype.
    Plain version on the CPU, the kernel on the GPU.
    """
    if x.device.type == "cpu":
        return unet_stage2_plain(x, w1, b1, w2, b2)
    require(x.device.type == "cuda", f"unet_stage2: no kernel for device {x.device}")
    B, C, H, W, Fo, K = check_stage("unet_stage2", x, w1, b1, w2, b2, KERNEL_SIZES)
    mid = conv_gemm.mid_like(x, Fo)
    act = torch.empty((B, Fo, H, W), dtype=x.dtype, device=x.device)
    pooled = torch.empty((B, Fo, H // 2, W // 2), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        conv_gemm.conv_gemm(x, w1, b1, mid, None, conv_gemm.LEAKY_STORE)
        conv_gemm.conv_gemm(mid, w2, b2, act, pooled, conv_gemm.LEAKY_AVG_POOL)
    count_launch(unet_stage2, x.dtype)
    return pooled, act


unet_stage2.launches_by_dtype = {}
