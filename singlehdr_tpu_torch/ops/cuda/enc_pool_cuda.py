"""K4: fused VGG encoder stage — ReLU conv3x3 x2 + 2x2 max pool.

Replaces ``singlehdr_tpu/ops/pallas/enc_pool_pallas.py`` (``encoder_stage2``),
which ran hal's enc1 (3->64) and enc2 (64->128) with the conv1 activation
kept in VMEM.  It is the same kernel as K2 (``csrc/conv2_pool.cu``: an
implicit GEMM conv on the tensor cores, 3xTF32 for f32 and one bf16 product
for bf16, two launches a stage) with ReLU and a SAME max pool over the
in-image members, written from registers.  enc2's 128 channels run as two
64-channel blocks per tile.  In
bf16 conv1's activation (stored channel-blocked, ``conv_gemm.mid_like``) and
the skip are rounded to bf16 and the max pool is taken of the rounded skip
(rounding is monotone, so pooling first gives the same values).

Layout: NCHW activations, OIHW weights.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.ops.cuda import conv_gemm
from singlehdr_tpu_torch.ops.cuda._check import count_launch, require
from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import check_stage


def encoder_stage2_plain(x, w1, b1, w2, b2):
    """Plain version: ``(max_pool_2x2_SAME(skip), skip)`` with
    ``skip = relu(conv3x3(relu(conv3x3(x, w1) + b1), w2) + b2)``.  For bf16
    x, w1, w2 (f32 biases): each conv in f32 on the bf16 values, conv1's
    activation and the skip rounded to bf16, the pool of the rounded skip."""
    if x.dtype == torch.bfloat16:
        mid = F.relu(F.conv2d(x.float(), w1.float(), b1, padding=1)).to(x.dtype)
        y = F.relu(F.conv2d(mid.float(), w2.float(), b2, padding=1)).to(x.dtype)
        return F.max_pool2d(y, 2, 2, ceil_mode=True), y
    y = F.relu(F.conv2d(x, w1, b1, padding=1))
    y = F.relu(F.conv2d(y, w2, b2, padding=1))
    return F.max_pool2d(y, 2, 2, ceil_mode=True), y


def encoder_stage2(x, w1, b1, w2, b2):
    """K4 wrapper: ``(pooled [B,F,ceil(H/2),ceil(W/2)], skip [B,F,H,W])``.

    x [B, C, H, W]; w1 [F, C, 3, 3]; b1 [F]; w2 [F, F, 3, 3]; b2 [F]; x, w1,
    w2 f32 or bf16, biases f32; outputs in x's dtype.
    Plain version on the CPU, the kernel on the GPU.
    """
    if x.device.type == "cpu":
        return encoder_stage2_plain(x, w1, b1, w2, b2)
    require(x.device.type == "cuda", f"encoder_stage2: no kernel for device {x.device}")
    B, C, H, W, Fo, _ = check_stage("encoder_stage2", x, w1, b1, w2, b2, (3,))
    mid = conv_gemm.mid_like(x, Fo)
    skip = torch.empty((B, Fo, H, W), dtype=x.dtype, device=x.device)
    pooled = torch.empty(
        (B, Fo, (H + 1) // 2, (W + 1) // 2), dtype=x.dtype, device=x.device
    )
    with torch.cuda.device(x.device):
        conv_gemm.conv_gemm(x, w1, b1, mid, None, conv_gemm.RELU_STORE)
        conv_gemm.conv_gemm(mid, w2, b2, skip, pooled, conv_gemm.RELU_MAX_POOL)
    count_launch(encoder_stage2, x.dtype)
    return pooled, skip


encoder_stage2.launches_by_dtype = {}
