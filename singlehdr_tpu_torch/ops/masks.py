"""Highlight-blend alpha (counterpart of ``singlehdr_tpu.ops.masks``)."""

from __future__ import annotations

import torch

HIGHLIGHT_THRESHOLD = 0.12


def highlight_alpha(x: torch.Tensor) -> torch.Tensor:
    """[b, 3, h, w] linear image -> [b, 3, h, w] alpha = clip((max_c x - 1 + t) / t, 0, 1)
    with t = HIGHLIGHT_THRESHOLD."""
    m = x.amax(dim=1, keepdim=True)
    t = HIGHLIGHT_THRESHOLD
    alpha = torch.clamp((m - 1.0 + t) / t, 0.0, 1.0)
    return alpha.expand_as(x)
