"""Spatial resampling with TF2 semantics, on NCHW tensors (counterpart of
``singlehdr_tpu.ops.resize``).

  * ``resize_bilinear_x2`` — tf.image.resize BILINEAR with half-pixel centers
    at an exact x2 scale: fixed (0.25, 0.75) weights with clamped edges.
  * ``avg_pool_2x2``       — keras AveragePooling2D((2, 2)), VALID.
  * ``max_pool``           — tf.nn.max_pool with SAME padding, which pads
    asymmetrically (more at the high end) with -inf.

On a spatial mesh (``mesh`` with S > 1; ``x`` is this rank's band of rows)
the resize and the pool take their halo rows from the neighbouring bands
(``parallel.mesh.extend_rows``): the resize one row each side, clamped at
the image's edges; the pool the SAME padding of the global height, -inf at
the image's edges.  The average pool needs none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.parallel.mesh import bands, extend_rows


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF 'SAME' (low, high) padding of an extent ``n`` for window ``k``,
    stride ``s``: the total is split with the odd element at the high end."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _upsample_axis_x2(x: torch.Tensor, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    lo = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
    hi = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
    even = 0.25 * lo + 0.75 * x
    odd = 0.75 * x + 0.25 * hi
    stacked = torch.stack([even, odd], dim=dim + 1)
    shape = list(x.shape)
    shape[dim] *= 2
    return stacked.reshape(shape)


def resize_bilinear_x2(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """[b, c, h, w] -> [b, c, 2h, 2w], TF2 half-pixel-center bilinear."""
    if bands(mesh) == 1:
        return _upsample_axis_x2(_upsample_axis_x2(x, 2), 3)
    rows = _upsample_axis_x2(extend_rows(x, 1, 1, mesh, "replicate"), 2)
    return _upsample_axis_x2(rows[:, :, 2:-2], 3)


def avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2x2 mean pool (VALID): [b, c, h, w] -> [b, c, h//2, w//2]."""
    return F.avg_pool2d(x, 2)


def band_pads(x: torch.Tensor, k: int, stride: int, mesh) -> tuple[int, int]:
    """The (low, high) SAME padding in H of a window ``k`` at ``stride`` on
    the global height of ``x``'s bands, which must start on the stride's
    grid."""
    if x.shape[2] % stride:
        raise ValueError(f"a band of {x.shape[2]} rows is not on a stride-{stride} grid")
    return same_pads(x.shape[2] * mesh.spatial, k, stride)


def max_pool(x: torch.Tensor, window: int, stride: int, mesh=None) -> torch.Tensor:
    """Max pool over H, W with TF 'SAME' padding (-inf, asymmetric)."""
    pl, pr = same_pads(x.shape[3], window, stride)
    if bands(mesh) > 1:
        pt, pb = band_pads(x, window, stride, mesh)
        x = extend_rows(x, pt, pb, mesh, value=float("-inf"))
        pt = pb = 0
    else:
        pt, pb = same_pads(x.shape[2], window, stride)
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb), value=float("-inf"))
    return F.max_pool2d(x, window, stride)
