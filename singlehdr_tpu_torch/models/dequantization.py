"""Dequantization-Net (counterpart of ``singlehdr_tpu.models.dequantization``):
a residual U-Net with a 256-wide bottleneck whose tanh-bounded residual is
added to the input (callers clip the sum to [0, 1]).  It computes in
``dtype`` and returns f32, as the Flax net does."""

from __future__ import annotations

import torch
import torch.nn as nn

from singlehdr_tpu_torch.models.layers import at_least_f32
from singlehdr_tpu_torch.models.unet import ResidualUNet


class DequantizationNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.unet = ResidualUNet(3, bottleneck_features=256, dtype=dtype)

    def forward(self, ldr: torch.Tensor) -> torch.Tensor:
        res = self.unet(ldr)
        return at_least_f32(ldr.to(res.dtype) + torch.tanh(res))
