"""Plain PyTorch tensor ops of the port, on NCHW tensors (counterpart of
``singlehdr_tpu.ops``); the hand CUDA kernels and their wrappers live in
``ops.cuda``."""

from singlehdr_tpu_torch.ops.color import bgr_to_rgb, flip_channels, vgg_preprocess
from singlehdr_tpu_torch.ops.curves import apply_rf, decode_invcrf, monotonic_rf
from singlehdr_tpu_torch.ops.histogram import linearization_features, soft_histogram
from singlehdr_tpu_torch.ops.masks import highlight_alpha
from singlehdr_tpu_torch.ops.resize import avg_pool_2x2, max_pool, resize_bilinear_x2
from singlehdr_tpu_torch.ops.sobel import sobel_edges

__all__ = [
    "apply_rf",
    "avg_pool_2x2",
    "bgr_to_rgb",
    "decode_invcrf",
    "flip_channels",
    "highlight_alpha",
    "linearization_features",
    "max_pool",
    "monotonic_rf",
    "resize_bilinear_x2",
    "sobel_edges",
    "soft_histogram",
    "vgg_preprocess",
]
