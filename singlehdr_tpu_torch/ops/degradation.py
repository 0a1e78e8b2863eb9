"""Camera-pipeline degradation simulator, HDR -> noisy, CRF'd, quantized LDR
(counterpart of ``singlehdr_tpu.ops.degradation``), on NCHW tensors.

``simulate_capture`` is split in two: ``draw_capture_noise`` draws the
random fields from an explicit ``torch.Generator`` (its numbers differ from
``jax.random``'s, so parity with JAX is statistical there), and
``capture_chain`` is the deterministic chain, exact against JAX given the
same fields:

  exposure   hdr * t                              (per-sample scalar t)
  noise      + N_s * (sigma_s * hdr_t) + N_c * sigma_c, sigma_s = 0.08/6 U[0,1),
             sigma_c = 0.005 U[0,1), per sample and channel
  relu, clip to [0, 1]
  CRF        apply_rf(clipped, crf)               (K1)
  quantize   round(ldr * 255) as uint8

The JPEG round trip runs on the host (``singlehdr_tpu_torch.data.jpeg``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from singlehdr_tpu_torch.ops.curves import apply_rf
from singlehdr_tpu_torch.ops.masks import exposure_loss_mask

SHOT_SIGMA = 0.08 / 6.0
READ_SIGMA = 0.005


class CaptureNoise(NamedTuple):
    sigma_s: torch.Tensor  # [b, 3, 1, 1]
    sigma_c: torch.Tensor  # [b, 3, 1, 1]
    noise_s: torch.Tensor  # [b, 3, h, w] standard normal
    noise_c: torch.Tensor  # [b, 3, h, w] standard normal


class CaptureSim(NamedTuple):
    """Simulator outputs, NCHW float32 but ``quantized_u8``."""

    hdr_t: torch.Tensor          # exposed + noised HDR (unclipped): hal target
    clipped_hdr_t: torch.Tensor  # clip(hdr_t, 0, 1): lin target, hal input
    ldr: torch.Tensor            # CRF-applied LDR in [0, 1]: deq target, lin input
    quantized_u8: torch.Tensor   # round(ldr * 255) as uint8: the JPEG input


def jpeg_quality_ladder(batch_size: int) -> list[int]:
    """Per-sample JPEG qualities 90..100: int(round(i/(B-1)*10 + 90))."""
    if batch_size == 1:
        return [90]
    return [int(round(float(i) / float(batch_size - 1) * 10.0 + 90.0)) for i in range(batch_size)]


def draw_capture_noise(generator: torch.Generator, hdr: torch.Tensor) -> CaptureNoise:
    """The random fields of one capture of ``hdr`` [b, 3, h, w], drawn on
    the generator's device."""
    b = hdr.shape[0]
    kw = dict(generator=generator, device=hdr.device, dtype=hdr.dtype)
    sigma_s = SHOT_SIGMA * torch.rand((b, 3, 1, 1), **kw)
    sigma_c = READ_SIGMA * torch.rand((b, 3, 1, 1), **kw)
    return CaptureNoise(sigma_s, sigma_c, torch.randn(hdr.shape, **kw), torch.randn(hdr.shape, **kw))


@torch.no_grad()
def capture_chain(hdr: torch.Tensor, crf: torch.Tensor, t: torch.Tensor,
                  noise: CaptureNoise) -> CaptureSim:
    """The deterministic chain: hdr [b, 3, h, w], crf [b, k], t [b]."""
    hdr_t = hdr * t.reshape(-1, 1, 1, 1)
    noise_s = noise.noise_s * (noise.sigma_s * hdr_t)
    noise_c = noise.noise_c * noise.sigma_c
    hdr_t = torch.relu(hdr_t + noise_s + noise_c)
    clipped = torch.clamp(hdr_t, 0.0, 1.0)
    ldr = apply_rf(clipped, crf)
    quantized = torch.round(ldr * 255.0).to(torch.uint8)
    return CaptureSim(hdr_t, clipped, ldr, quantized)


def simulate_capture(generator: torch.Generator, hdr, crf, t) -> CaptureSim:
    """One simulated capture of a batch (``draw_capture_noise`` + ``capture_chain``)."""
    return capture_chain(hdr, crf, t, draw_capture_noise(generator, hdr))


def loss_mask_from_levels(levels: torch.Tensor) -> torch.Tensor:
    """[b, 3, h, w] 8-bit levels (uint8 or float) -> [b, 1, 1, 1] loss mask."""
    return exposure_loss_mask(levels.float())
