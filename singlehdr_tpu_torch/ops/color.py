"""Channel-order conversions on NCHW tensors (counterpart of
``singlehdr_tpu.ops.color``).  RGB<->BGR is one channel reversal, an
involution, so one ``flip_channels`` covers both directions."""

from __future__ import annotations

import torch

# ImageNet BGR means used by VGG16 and the Hallucination-Net preamble.
VGG_MEAN_BGR = (103.939, 116.779, 123.68)

# Luma weights of tf.image.rgb_to_grayscale (ITU-R BT.601).
_LUMA_RGB = (0.2989, 0.587, 0.114)


def flip_channels(x: torch.Tensor) -> torch.Tensor:
    """Reverse the channel axis (dim 1) — RGB <-> BGR."""
    return torch.flip(x, dims=(1,))


bgr_to_rgb = flip_channels


def rgb_to_grayscale_u8(rgb_u8: torch.Tensor) -> torch.Tensor:
    """BT.601 luma of [b, 3, h, w] 8-bit levels (any dtype), rounded half to
    even -> [b, 1, h, w] float32 holding integer levels."""
    x = rgb_u8.float()
    lum = _LUMA_RGB[0] * x[:, 0] + _LUMA_RGB[1] * x[:, 1] + _LUMA_RGB[2] * x[:, 2]
    return torch.round(lum)[:, None]


def vgg_preprocess(rgb01: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """Scale [0, 1] RGB to 0..255, reorder to BGR, subtract per-channel means."""
    return flip_channels(rgb01 * 255.0) - mean.reshape(1, -1, 1, 1)
