"""Channel-order conversions on NCHW tensors (counterpart of
``singlehdr_tpu.ops.color``).  RGB<->BGR is one channel reversal, an
involution, so one ``flip_channels`` covers both directions."""

from __future__ import annotations

import torch

# ImageNet BGR means used by VGG16 and the Hallucination-Net preamble.
VGG_MEAN_BGR = (103.939, 116.779, 123.68)


def flip_channels(x: torch.Tensor) -> torch.Tensor:
    """Reverse the channel axis (dim 1) — RGB <-> BGR."""
    return torch.flip(x, dims=(1,))


bgr_to_rgb = flip_channels


def vgg_preprocess(rgb01: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Scale [0, 1] RGB to 0..255, reorder to BGR, subtract per-channel means."""
    return flip_channels(rgb01 * 255.0) - mean.reshape(1, -1, 1, 1)
