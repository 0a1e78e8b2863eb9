"""Linearization-Net: predicts a monotone 1024-sample inverse CRF from an LDR
(counterpart of ``singlehdr_tpu.models.linearization``).

A 93-channel feature stack feeds a 7x7/2 stem + BN + ReLU, a 3x3/2 SAME max
pool, five bottleneck residual blocks and a global average pool; Dense(11)
predicts PCA weights over the inverse-EMoR basis (``g0 + Hinv @ w``) and the
curve is projected to be monotone.  In eval the feature stack and the stem
run as the K3 wrapper ``lin_feature_stem`` with the stem BN folded into the
conv (the CUDA kernel on the GPU, its plain version on the CPU).

``dtype`` is the compute dtype of the feature stack, the stem and the
residual blocks (K3 in its bf16 form for bf16); the pooled features go to
the Dense head in f32, and the curve decode and monotone projection stay
f32, as in the Flax net.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from singlehdr_tpu_torch.calib import load_inverse_emor
from singlehdr_tpu_torch.models.layers import BatchNorm, Conv2d, Dense, at_least_f32
from singlehdr_tpu_torch.ops.cuda.conv_gemm import cached_on
from singlehdr_tpu_torch.ops.cuda.lin_stem_cuda import lin_feature_stem
from singlehdr_tpu_torch.ops.curves import decode_invcrf, monotonic_rf
from singlehdr_tpu_torch.ops.histogram import N_FEATURES, linearization_features
from singlehdr_tpu_torch.ops.resize import max_pool
from singlehdr_tpu_torch.parallel.mesh import bands, on_extended_band, spatial_sum

N_PCA_WEIGHTS = 11
K3_HALO = 4  # rows on each inner side of a band: Sobel's 1 + the stem's (2, 3), made even


def feature_stem(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, mesh=None):
    """K3 on ``x``; on a spatial ``mesh`` on the band extended by K3_HALO
    rows on each inner side, cropped back."""
    if bands(mesh) == 1:
        return lin_feature_stem(x, kernel, bias)
    return on_extended_band(lambda t: lin_feature_stem(t, kernel, bias), x, K3_HALO, mesh)


class BottleneckResBlock(nn.Module):
    """1-3-1 bottleneck residual block; bias-free convs, BN after each."""

    def __init__(self, cin: int, filters: tuple[int, int, int], stride: int = 1,
                 projection: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        f1, f2, f3 = filters
        self.projection = projection
        if projection:
            self.proj_conv = Conv2d(cin, f3, 1, stride, bias=False, dtype=dtype)
            self.proj_bn = BatchNorm(f3, dtype)
        self.conv1 = Conv2d(cin, f1, 1, stride, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(f1, dtype)
        self.conv2 = Conv2d(f1, f2, 3, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(f2, dtype)
        self.conv3 = Conv2d(f2, f3, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm(f3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = self.proj_bn(self.proj_conv(x)) if self.projection else x
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return torch.relu(shortcut + h)


class CrfFeatureNet(nn.Module):
    """Feature stack + stem + max pool + res1..res5 + global average -> [b, 512]."""

    mesh = None

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = Conv2d(N_FEATURES, 64, 7, stride=2, dtype=dtype)
        self.stem_bn = BatchNorm(64, dtype)
        self.res1 = BottleneckResBlock(64, (64, 64, 256), projection=True, dtype=dtype)
        self.res2 = BottleneckResBlock(256, (64, 64, 256), dtype=dtype)
        self.res3 = BottleneckResBlock(256, (64, 64, 256), dtype=dtype)
        self.res4 = BottleneckResBlock(256, (128, 128, 512), stride=2, projection=True,
                                       dtype=dtype)
        self.res5 = BottleneckResBlock(512, (128, 128, 512), dtype=dtype)

    def folded_stem(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The eval stem with its BN folded in: (kernel in the compute dtype,
        bias f32), computed in f32 as the Flax net does.  Kept while the
        stem's weight and bias and the four BN tensors are unchanged (their
        data and versions), so K3 is handed the same tensor each forward and
        packs it once (``lin_stem_cuda.packed_stem_weights``)."""
        def fold():
            scale, shift = self.stem_bn.folded()
            k = (self.stem.weight * scale[:, None, None, None]).to(self.dtype)
            return k, self.stem.bias * scale + shift

        src = (self.stem.weight, self.stem.bias, self.stem_bn.weight, self.stem_bn.bias,
               self.stem_bn.running_mean, self.stem_bn.running_var)
        return cached_on(self, f"folded_stem:{self.dtype}", src, fold)

    def forward(self, ldr: torch.Tensor) -> torch.Tensor:
        x, mesh = ldr.to(self.dtype), self.mesh
        if self.training:
            h = self.stem(linearization_features(x, mesh))
            h = torch.relu(self.stem_bn(h))
        else:
            h = feature_stem(x, *self.folded_stem(), mesh)
        h = max_pool(h, 3, 2, mesh)
        for block in (self.res1, self.res2, self.res3, self.res4, self.res5):
            h = block(h)
        if bands(mesh) == 1:
            return h.mean(dim=(2, 3))
        n = h.shape[2] * h.shape[3] * mesh.spatial
        return (spatial_sum(at_least_f32(h).sum(dim=(2, 3)), mesh) / n).to(h.dtype)


class LinearizationNet(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.crf_feature_net = CrfFeatureNet(dtype)
        self.pca_head = Dense(512, N_PCA_WEIGHTS)
        inv_emor = load_inverse_emor()
        # constants of the decoder, not weights: kept out of the state_dict
        self.register_buffer(
            "g0", torch.as_tensor(inv_emor.mean, dtype=torch.float32), persistent=False
        )
        self.register_buffer(
            "hinv", torch.as_tensor(inv_emor.basis, dtype=torch.float32), persistent=False
        )

    def forward(self, ldr: torch.Tensor) -> torch.Tensor:
        w = self.pca_head(at_least_f32(self.crf_feature_net(ldr)))
        return monotonic_rf(decode_invcrf(w, self.g0, self.hinv))
