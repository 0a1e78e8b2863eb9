"""Log-domain tonemaps of the HDR losses (counterpart of
``singlehdr_tpu.ops.tonemap``).

  * ``mu_tonemap``: log(1 + 10x) / log(11), applied before every
    Hallucination/Refinement loss and the VGG perceptual features.
  * ``hdr_log_compression`` / ``hdr_log_decompression``: the validDR = 5000
    pair of the reference's op library (tf_utils.py:113-131).
"""

from __future__ import annotations

import numpy as np
import torch


def _inv_log1p(v: float) -> float:
    # 1 / log1p(v) rounded in float32, as the JAX package computes it
    return float(np.float32(1.0) / np.log1p(np.float32(v)))


def mu_tonemap(x: torch.Tensor, mu: float = 10.0) -> torch.Tensor:
    """log(1 + mu*x) / log(1 + mu)."""
    return torch.log1p(mu * x) * _inv_log1p(mu)


def hdr_log_compression(x: torch.Tensor, valid_dr: float = 5000.0) -> torch.Tensor:
    """log(1 + validDR*x)/log(1 + validDR) - 1."""
    return torch.log1p(valid_dr * x) / float(np.log1p(np.float32(valid_dr))) - 1.0


def hdr_log_decompression(x: torch.Tensor, valid_dr: float = 5000.0) -> torch.Tensor:
    """Inverse of ``hdr_log_compression``."""
    return torch.exp((x + 1.0) * float(np.log1p(np.float32(valid_dr)))) / valid_dr
