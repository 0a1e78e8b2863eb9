"""Refinement-Net (counterpart of ``singlehdr_tpu.models.refinement``): the
U-Net with a 128-wide bottleneck over concat[A, B, C] (9 channels), its
residual added to A with a ReLU output.  It computes in ``dtype`` and returns
f32, as the Flax net does."""

from __future__ import annotations

import torch
import torch.nn as nn

from singlehdr_tpu_torch.models.layers import at_least_f32
from singlehdr_tpu_torch.models.unet import ResidualUNet


class RefinementNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.unet = ResidualUNet(9, bottleneck_features=128, dtype=dtype)

    def forward(self, abc: torch.Tensor) -> torch.Tensor:
        res = self.unet(abc)
        return at_least_f32(torch.relu(abc[:, 0:3].to(res.dtype) + res))
