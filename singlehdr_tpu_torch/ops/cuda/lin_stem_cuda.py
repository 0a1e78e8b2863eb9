"""K3: Linearization-Net front end — the 93-channel feature stack and the
BN-folded 7x7/2 stem in one pass.

Replaces ``singlehdr_tpu/ops/pallas/lin_stem_pallas.py`` (``lin_feature_stem``),
which kept the 93-channel stack out of HBM.  ``csrc/lin_stem.cu`` computes
each block's features in shared memory, 16 channels at a time, and runs the
stem over them, so the stack never reaches device memory either.  The kernel
applies the border rules itself — Sobel REFLECT padding, the stack zero-padded
as features, asymmetric SAME padding at stride 2 — so the TPU wrapper's
border-ring recompute has no counterpart here.  FMA-bound in f32
(49 * 93 * 64 FMAs per output pixel).

Layout: x [B, 3, H, W]; kernel OIHW [64, 93, 7, 7]; output NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.ops.cuda import _build
from singlehdr_tpu_torch.ops.cuda._check import (
    count_launch,
    cuda_f32,
    no_grad_needed,
    ptr,
    require,
    stream,
)
from singlehdr_tpu_torch.ops.histogram import N_FEATURES, linearization_features
from singlehdr_tpu_torch.ops.resize import same_pads

OUT_F = 64


def lin_feature_stem_plain(x, kernel7, bias):
    """Plain version: ``relu(conv7x7/2_SAME(linearization_features(x)) + bias)``."""
    feats = linearization_features(x)
    pt, pb = same_pads(x.shape[2], 7, 2)
    pl, pr = same_pads(x.shape[3], 7, 2)
    feats = F.pad(feats, (pl, pr, pt, pb))
    return F.relu(F.conv2d(feats, kernel7, bias, stride=2))


def lin_feature_stem(x, kernel7, bias):
    """K3 wrapper: [B, 3, H, W] -> [B, 64, ceil(H/2), ceil(W/2)].

    ``kernel7`` [64, 93, 7, 7] / ``bias`` [64] are the BN-folded eval stem.
    Plain version on the CPU, the kernel on the GPU.
    """
    if x.device.type == "cpu":
        return lin_feature_stem_plain(x, kernel7, bias)
    require(x.device.type == "cuda", f"lin_feature_stem: no kernel for device {x.device}")
    cuda_f32("lin_feature_stem: x", x, x.device, 4)
    cuda_f32("lin_feature_stem: kernel7", kernel7, x.device, 4)
    cuda_f32("lin_feature_stem: bias", bias, x.device, 1)
    B, C, H, W = x.shape
    require(C == 3, f"lin_feature_stem: {C} input channels, expected 3")
    require(B > 0 and H > 0 and W > 0, f"lin_feature_stem: empty input {tuple(x.shape)}")
    require(tuple(kernel7.shape) == (OUT_F, N_FEATURES, 7, 7),
            f"lin_feature_stem: kernel {tuple(kernel7.shape)} != {(OUT_F, N_FEATURES, 7, 7)}")
    require(tuple(bias.shape) == (OUT_F,), f"lin_feature_stem: bias must be [{OUT_F}]")
    no_grad_needed("lin_feature_stem", x, kernel7, bias)
    ho, wo = -(-H // 2), -(-W // 2)
    pad_t, _ = same_pads(H, 7, 2)
    pad_l, _ = same_pads(W, 7, 2)
    out = torch.empty((B, OUT_F, ho, wo), dtype=x.dtype, device=x.device)
    wt = kernel7.permute(1, 2, 3, 0).contiguous()  # [93][7][7][64]
    with torch.cuda.device(x.device):
        _build.call(
            "shdr_lin_stem_f32", ptr(x), ptr(wt), ptr(bias), ptr(out),
            B, H, W, ho, wo, pad_t, pad_l, stream(x.device),
        )
    count_launch(lin_feature_stem)
    return out


lin_feature_stem.launches = 0
