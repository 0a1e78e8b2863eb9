"""Shared residual U-Net backbone of the Dequantization and Refinement nets
(counterpart of ``singlehdr_tpu.models.unet``).

A 7x7 stem pair at 16 channels, avg-pool down stages at 32/64/128 (K 5/3/3),
a 3x3 bottleneck stage, bilinear-x2 up stages with skip concats, and a
3-channel 3x3 head.  The nets differ only in input channels and bottleneck
width.  In eval the encoder prefix — the stem pair, down2 and down3 — runs
through the K2 wrapper ``unet_stage2`` (the CUDA kernel on the GPU, its plain
version on the CPU); down4, the bottleneck and the decoder stay ``F.conv2d``.
Training takes the plain convs throughout (K2 has no backward).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from singlehdr_tpu_torch.models.layers import Conv2d, leaky_relu
from singlehdr_tpu_torch.ops.cuda.unet_stage_cuda import unet_stage2
from singlehdr_tpu_torch.ops.resize import avg_pool_2x2, resize_bilinear_x2

STEM_FEATURES = 16
STEM_KERNEL = 7
DOWN = ((32, 5), (64, 3), (128, 3))  # down2, down3, down4: (features, kernel)


class DownStage(nn.Module):
    """avg-pool /2 then two leaky-ReLU convs."""

    def __init__(self, cin: int, features: int, kernel: int):
        super().__init__()
        self.conv1 = Conv2d(cin, features, kernel)
        self.conv2 = Conv2d(features, features, kernel)

    def forward(self, x: torch.Tensor, pre_pooled: bool = False) -> torch.Tensor:
        if not pre_pooled:
            x = avg_pool_2x2(x)
        return leaky_relu(self.conv2(leaky_relu(self.conv1(x))))


class UpStage(nn.Module):
    """bilinear x2, conv, concat with the skip, conv (leaky-ReLU after each)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = Conv2d(cin, features, 3)
        self.conv2 = Conv2d(2 * features, features, 3)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.conv1(resize_bilinear_x2(x)))
        return leaky_relu(self.conv2(torch.cat([x, skip], dim=1)))


def _k2(x: torch.Tensor, conv1: Conv2d, conv2: Conv2d):
    """One K2 stage: (avg_pool_2x2(act), act) with act the two-conv output."""
    return unet_stage2(x, conv1.weight, conv1.bias, conv2.weight, conv2.bias)


class ResidualUNet(nn.Module):
    """Encoder-decoder returning the raw 3-channel head output; H, W must be
    multiples of 16."""

    def __init__(self, in_channels: int, bottleneck_features: int):
        super().__init__()
        self.stem1 = Conv2d(in_channels, STEM_FEATURES, STEM_KERNEL)
        self.stem2 = Conv2d(STEM_FEATURES, STEM_FEATURES, STEM_KERNEL)
        (f2, k2), (f3, k3), (f4, k4) = DOWN
        self.down2 = DownStage(STEM_FEATURES, f2, k2)
        self.down3 = DownStage(f2, f3, k3)
        self.down4 = DownStage(f3, f4, k4)
        self.bottleneck = DownStage(f4, bottleneck_features, 3)
        self.up4 = UpStage(bottleneck_features, f4)
        self.up3 = UpStage(f4, f3)
        self.up2 = UpStage(f3, f2)
        self.up1 = UpStage(f2, STEM_FEATURES)
        self.head = Conv2d(STEM_FEATURES, 3, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            s1 = leaky_relu(self.stem2(leaky_relu(self.stem1(x))))
            s2 = self.down2(s1)
            s3 = self.down3(s2)
            s4 = self.down4(s3)
        else:
            h, s1 = _k2(x, self.stem1, self.stem2)
            h, s2 = _k2(h, self.down2.conv1, self.down2.conv2)
            h, s3 = _k2(h, self.down3.conv1, self.down3.conv2)
            s4 = self.down4(h, pre_pooled=True)
        h = self.bottleneck(s4)
        h = self.up4(h, s4)
        h = self.up3(h, s3)
        h = self.up2(h, s2)
        h = self.up1(h, s1)
        return self.head(h)
