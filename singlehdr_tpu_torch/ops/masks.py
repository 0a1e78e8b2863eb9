"""Highlight-blend alpha, the exposure loss mask and ``jnp.clip``'s tie rule
(counterpart of ``singlehdr_tpu.ops.masks``)."""

from __future__ import annotations

import torch

from singlehdr_tpu_torch.ops.color import rgb_to_grayscale_u8

HIGHLIGHT_THRESHOLD = 0.12
_REF_PIXEL_BUDGET = 256.0 * 256.0 * 0.5


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: maximum, then minimum.  The value is ``torch.clamp``'s;
    the gradient at x == lo or x == hi is 0.5, as in JAX (clamp gives 1)."""
    def bound(v):
        return torch.full((), v, dtype=x.dtype, device=x.device)

    return torch.minimum(torch.maximum(x, bound(lo)), bound(hi))


def highlight_alpha(x: torch.Tensor) -> torch.Tensor:
    """[b, 3, h, w] linear image -> [b, 3, h, w] alpha = clip((max_c x - 1 + t) / t, 0, 1)
    with t = HIGHLIGHT_THRESHOLD."""
    m = x.amax(dim=1, keepdim=True)
    t = HIGHLIGHT_THRESHOLD
    alpha = clip((m - 1.0 + t) / t, 0.0, 1.0)
    return alpha.expand_as(x)


def exposure_loss_mask(rgb_u8: torch.Tensor, over_level: float = 249.0,
                       under_level: float = 6.0) -> torch.Tensor:
    """Per-sample {0, 1} mask [b, 1, 1, 1] that drops a sample whose gray
    levels are >= 249 or <= 6 on more than 256*256/2 pixels (the reference's
    fixed budget, train.py:61-70).  ``rgb_u8``: [b, 3, h, w] 8-bit levels."""
    gray = rgb_to_grayscale_u8(rgb_u8)
    over = (gray >= over_level).float().sum(dim=(2, 3), keepdim=True)
    under = (gray <= under_level).float().sum(dim=(2, 3), keepdim=True)
    extreme = (over > _REF_PIXEL_BUDGET) | (under > _REF_PIXEL_BUDGET)
    return (~extreme).float()
