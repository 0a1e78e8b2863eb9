"""Soft-histogram features and the Linearization-Net's 93-channel input stack,
on NCHW tensors (counterpart of ``singlehdr_tpu.ops.histogram``).

Per-pixel triangular soft binning: for bin i in 1..B with center
c_i = (2i-1)/(2B), the response is relu(1 - |x - c_i| * B).  The stack is
image (3) | Sobel dy/dx color-major (6) | histograms at 4, 8, 16 bins,
bin-major with RGB inside each bin (12 + 24 + 48).
"""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.sobel import sobel_edges

HISTOGRAM_BINS = (4, 8, 16)
N_FEATURES = 3 + 6 + sum(3 * b for b in HISTOGRAM_BINS)  # 93


def soft_histogram(img: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[b, c, h, w] -> [b, n_bins*c, h, w], bin-major channel order."""
    b, c, h, w = img.shape
    centers = (
        2.0 * torch.arange(1, n_bins + 1, dtype=img.dtype, device=img.device) - 1.0
    ) / (2.0 * n_bins)
    d = torch.abs(img[:, None] - centers[None, :, None, None, None])  # [b,bins,c,h,w]
    resp = torch.clamp(1.0 - d * n_bins, min=0.0)
    return resp.reshape(b, n_bins * c, h, w)


def linearization_features(img: torch.Tensor, mesh=None) -> torch.Tensor:
    """[b, 3, h, w] -> [b, 93, h, w]: [img, sobel(6), hist4, hist8, hist16],
    in the working type of ``img``.  A bf16 stack is computed in f32 from the
    bf16 image and each feature is rounded once, where K3's kernel rounds (the
    JAX package lets XLA round its bf16 Sobel and histogram arithmetic at
    points of its own; ``tests/test_torch_bf16.py`` bounds the difference).
    On a spatial ``mesh`` ``img`` is a band (``sobel_edges``' halo)."""
    x = img.float() if img.dtype == torch.bfloat16 else img
    parts = [x, sobel_edges(x, mesh)]
    parts += [soft_histogram(x, n) for n in HISTOGRAM_BINS]
    return torch.cat(parts, dim=1).to(img.dtype)
