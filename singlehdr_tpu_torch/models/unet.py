"""Shared residual U-Net backbone of the Dequantization and Refinement nets
(counterpart of ``singlehdr_tpu.models.unet``).

A 7x7 stem pair at 16 channels, avg-pool down stages at 32/64/128 (K 5/3/3),
a 3x3 bottleneck stage, bilinear-x2 up stages with skip concats, and a
3-channel 3x3 head.  The nets differ only in input channels and bottleneck
width.  In eval the encoder prefix — the stem pair, down2 and down3 — runs
through the K2 wrapper ``unet_stage2`` (the CUDA kernel on the GPU, its plain
version on the CPU); down4, the bottleneck and the decoder stay ``F.conv2d``.
Training takes the plain convs throughout (K2 has no backward).

On a spatial mesh (``layers.bind_mesh``; the input is this rank's band of
rows) every conv and resize exchanges its halo rows, and a K2 stage runs
unchanged on the band extended by 2 (K // 2) rows on each inner side, its
outputs cropped back (``parallel.mesh.on_extended_band``).  H / S must be a
multiple of 16.

``dtype`` is the compute dtype (f32 or bf16): the input is cast to it, every
conv runs in it (K2 in its bf16 form for bf16), and the head's output is in
it; the wrapping nets return f32.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from singlehdr_tpu_torch.models.layers import Conv2d, leaky_relu
from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2
from singlehdr_tpu_torch.ops.resize import avg_pool_2x2, resize_bilinear_x2
from singlehdr_tpu_torch.parallel.mesh import bands, on_extended_band

STEM_FEATURES = 16
STEM_KERNEL = 7
DOWN = ((32, 5), (64, 3), (128, 3))  # down2, down3, down4: (features, kernel)


class DownStage(nn.Module):
    """avg-pool /2 then two leaky-ReLU convs."""

    def __init__(self, cin: int, features: int, kernel: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, features, kernel, dtype=dtype)
        self.conv2 = Conv2d(features, features, kernel, dtype=dtype)

    def forward(self, x: torch.Tensor, pre_pooled: bool = False) -> torch.Tensor:
        if not pre_pooled:
            x = avg_pool_2x2(x)
        return leaky_relu(self.conv2(leaky_relu(self.conv1(x))))


class UpStage(nn.Module):
    """bilinear x2, conv, concat with the skip, conv (leaky-ReLU after each)."""

    mesh = None

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3, dtype=dtype)
        self.conv2 = Conv2d(2 * features, features, 3, dtype=dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.conv1(resize_bilinear_x2(x, self.mesh)))
        return leaky_relu(self.conv2(torch.cat([x, skip], dim=1)))


def _k2(x: torch.Tensor, conv1: Conv2d, conv2: Conv2d, mesh=None):
    """One K2 stage: (avg_pool_2x2(act), act) with act the two-conv output;
    the kernels in the compute dtype, the biases f32.  On a spatial ``mesh``
    on the band extended by the two convs' reach, 2 (K // 2) rows."""
    w1, w2 = conv1.compute_weight(), conv2.compute_weight()

    def stage(t):
        return unet_stage2(t, w1, conv1.bias, w2, conv2.bias)

    if bands(mesh) == 1:
        return stage(x)
    return on_extended_band(stage, x, 2 * (w1.shape[-1] // 2), mesh)


class ResidualUNet(nn.Module):
    """Encoder-decoder returning the raw 3-channel head output; H, W must be
    multiples of 16."""

    mesh = None

    def __init__(self, in_channels: int, bottleneck_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem1 = Conv2d(in_channels, STEM_FEATURES, STEM_KERNEL, dtype=dtype)
        self.stem2 = Conv2d(STEM_FEATURES, STEM_FEATURES, STEM_KERNEL, dtype=dtype)
        (f2, k2), (f3, k3), (f4, k4) = DOWN
        self.down2 = DownStage(STEM_FEATURES, f2, k2, dtype)
        self.down3 = DownStage(f2, f3, k3, dtype)
        self.down4 = DownStage(f3, f4, k4, dtype)
        self.bottleneck = DownStage(f4, bottleneck_features, 3, dtype)
        self.up4 = UpStage(bottleneck_features, f4, dtype)
        self.up3 = UpStage(f4, f3, dtype)
        self.up2 = UpStage(f3, f2, dtype)
        self.up1 = UpStage(f2, STEM_FEATURES, dtype)
        self.head = Conv2d(STEM_FEATURES, 3, 3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.training:
            s1 = leaky_relu(self.stem2(leaky_relu(self.stem1(x))))
            s2 = self.down2(s1)
            s3 = self.down3(s2)
            s4 = self.down4(s3)
        else:
            h, s1 = _k2(x, self.stem1, self.stem2, self.mesh)
            h, s2 = _k2(h, self.down2.conv1, self.down2.conv2, self.mesh)
            h, s3 = _k2(h, self.down3.conv1, self.down3.conv2, self.mesh)
            s4 = self.down4(h, pre_pooled=True)
        h = self.bottleneck(s4)
        h = self.up4(h, s4)
        h = self.up3(h, s3)
        h = self.up2(h, s2)
        h = self.up1(h, s1)
        return self.head(h)
