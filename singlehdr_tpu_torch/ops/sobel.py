"""Sobel edge maps matching tf.image.sobel_edges, on NCHW tensors (counterpart
of ``singlehdr_tpu.ops.sobel``).

REFLECT-pad by 1 pixel, then per channel dy = [1,2,1]-smooth along W and
difference along H, dx the transpose; channels come out color-major
(c0_dy, c0_dx, c1_dy, c1_dx, ...).  On a spatial mesh (``mesh`` with S > 1)
the row above and below a band come from its neighbours, REFLECT at the
image's edges (``parallel.mesh.extend_rows``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from singlehdr_tpu_torch.parallel.mesh import bands, extend_rows


def sobel_edges(img: torch.Tensor, mesh=None) -> torch.Tensor:
    """[b, c, h, w] -> [b, 2c, h, w] interleaved (dy, dx) per channel."""
    b, c, h, w = img.shape
    if bands(mesh) == 1:
        xp = F.pad(img, (1, 1, 1, 1), mode="reflect")
    else:
        xp = F.pad(extend_rows(img, 1, 1, mesh, "reflect"), (1, 1, 0, 0), mode="reflect")
    sw = xp[:, :, :, 0:w] + 2.0 * xp[:, :, :, 1 : w + 1] + xp[:, :, :, 2 : w + 2]
    dy = sw[:, :, 2 : h + 2] - sw[:, :, 0:h]
    sh = xp[:, :, 0:h] + 2.0 * xp[:, :, 1 : h + 1] + xp[:, :, 2 : h + 2]
    dx = sh[:, :, :, 2 : w + 2] - sh[:, :, :, 0:w]
    return torch.stack([dy, dx], dim=2).reshape(b, 2 * c, h, w)
