"""Hallucination-Net: recovers clipped highlights as a residual, output BGR
(counterpart of ``singlehdr_tpu.models.hallucination``).

The input is VGG-preprocessed (x255, RGB->BGR, minus the stored means), encoded
by a VGG16-layout stack (64/128/256/512/512 with 2-2-3-3-3 convs and 2x2 max
pools), a 3x3x512 latent conv + BN, and decoded by bilinear-x2 up stages with
1x1 skip fusions over concat(x, skip/255); the last fusion takes the
preprocessed BGR input itself.  In eval enc1 and enc2 run as the K4 wrapper
``encoder_stage2`` (the CUDA kernel on the GPU, its plain version on the CPU);
enc3..enc5, the latent conv and the decoder stay ``F.conv2d``.  The
reference's unused second conv of the up block is not reproduced.

``dtype`` is the compute dtype: the preprocessed input is cast to it, every
layer runs in it (K4 in its bf16 form for bf16), and the BGR residual comes
back in f32, as in the Flax net.  A skip fusion folds the skip's 1/255 into
its kernel rows in f32 before the cast, where the Flax net scales it.

On a spatial mesh (``layers.bind_mesh``; the input is this rank's band of
rows, H / S a multiple of 32) the 3x3 convs and the decoder's resizes
exchange their halo rows, the 2x2 pools and the 1x1 fusions need none, and
K4 runs unchanged on the band extended by 2 rows on each inner side, its
outputs cropped back.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from singlehdr_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    UpsampleConv,
    at_least_f32,
    cast_param,
)
from singlehdr_tpu_torch.ops.color import VGG_MEAN_BGR, vgg_preprocess
from singlehdr_tpu_torch.ops.cuda.conv_gemm import cached_on
from singlehdr_tpu_torch.ops.cuda.enc_pool_cuda import encoder_stage2
from singlehdr_tpu_torch.ops.resize import max_pool
from singlehdr_tpu_torch.parallel.mesh import bands, on_extended_band

_ENC = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
K4_HALO = 2  # rows on each inner side of a band: the two 3x3 convs' reach


class EncoderStage(nn.Module):
    """n ReLU 3x3 convs then a 2x2/2 SAME max pool; returns (pooled, skip)."""

    mesh = None

    def __init__(self, cin: int, features: int, n_convs: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"conv{i + 1}",
                            Conv2d(cin if i == 0 else features, features, 3, dtype=dtype))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if not self.training and self.n_convs == 2:
            w1, w2 = self.conv1.compute_weight(), self.conv2.compute_weight()

            def stage(t):
                return encoder_stage2(t, w1, self.conv1.bias, w2, self.conv2.bias)

            return stage(x) if bands(self.mesh) == 1 else on_extended_band(stage, x, K4_HALO, self.mesh)
        for i in range(self.n_convs):
            x = torch.relu(getattr(self, f"conv{i + 1}")(x))
        return max_pool(x, 2, 2, self.mesh), x


class DecoderStage(nn.Module):
    """bilinear x2 -> conv3x3 -> ReLU -> BN -> ReLU."""

    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = UpsampleConv(cin, features, dtype)
        self.bn = BatchNorm(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(torch.relu(self.conv(x))))


class SkipFusion(nn.Module):
    """conv1x1(concat(x, skip / 255)), with the 1/255 folded into the skip's
    kernel rows in f32 (as the Flax net does) rather than into the skip."""

    def __init__(self, cx: int, cskip: int, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cx = cx
        self.conv = Conv2d(cx + cskip, features, 1, dtype=dtype)

    def _kernel(self) -> torch.Tensor:
        w = self.conv.weight
        return torch.cat([w[:, :self.cx], w[:, self.cx:] * (1.0 / 255.0)], dim=1)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        dtype = self.conv.dtype
        # eval: folded and cast once while the weight is unchanged
        k = cached_on(self, f"kernel:{dtype}", (self.conv.weight,), lambda: self._kernel().to(dtype))
        x, skip, bias = x.to(dtype), skip.to(dtype), cast_param(self.conv, "bias", dtype)
        if dtype == torch.float32:
            return F.conv2d(torch.cat([x, skip], dim=1), k, bias)
        # Flax's split form: each half's product rounded, their sum, then the bias
        return F.conv2d(x, k[:, :self.cx]) + F.conv2d(skip, k[:, self.cx:]) + bias[:, None, None]


class HallucinationNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # stored, not constant: BGR-adapted reference weights reverse it
        self.register_buffer("preproc_mean", torch.tensor(VGG_MEAN_BGR, dtype=torch.float32))
        cin = 3
        for i, (f, n) in enumerate(_ENC):
            self.add_module(f"enc{i + 1}", EncoderStage(cin, f, n, dtype))
            cin = f
        self.latent_conv = Conv2d(512, 512, 3, dtype=dtype)
        self.latent_bn = BatchNorm(512, dtype)
        for i in range(len(_ENC), 0, -1):
            f = _ENC[i - 1][0]
            self.add_module(f"dec{i}", DecoderStage(cin, f, dtype))
            self.add_module(f"skip{i}", SkipFusion(f, f, f, dtype))
            cin = f
        self.head_conv = Conv2d(64, 3, 1, dtype=dtype)
        self.head_bn = BatchNorm(3, dtype)
        self.skip0 = SkipFusion(3, 3, 3, dtype)

    def forward(self, rgb01: torch.Tensor) -> torch.Tensor:
        bgr = vgg_preprocess(rgb01, self.preproc_mean).to(self.dtype)
        x = bgr
        skips = []
        for i in range(len(_ENC)):
            x, s = getattr(self, f"enc{i + 1}")(x)
            skips.append(s)
        x = torch.relu(self.latent_bn(self.latent_conv(x)))
        for i in range(len(_ENC), 0, -1):
            x = getattr(self, f"dec{i}")(x)
            x = getattr(self, f"skip{i}")(x, skips[i - 1])
        x = torch.relu(self.head_bn(self.head_conv(x)))
        return at_least_f32(torch.relu(self.skip0(x, bgr)))  # BGR residual
