"""Seeded smooth scenes, made on the device in batches.

The recipe of the quality anchor's ``synth_scene``: low-frequency radiance
(four 2-D sinusoids a channel, exponentiated), matte rectangles and disks
of random albedo, and bright emitters with a soft glow.  Every image has
the same number of shapes (10) and emitters (2), so that all seeds make the
same amount of work and the batch can be drawn in a few large calls.

``hdr_scenes`` gives linear radiance; ``ldr_images`` tone-maps it to 8-bit
RGB (mean to 0.5, gamma 2.2, clipped), NHWC uint8 on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

N_SHAPES = 10
N_EMITTERS = 2


def _u(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def hdr_scenes(gen: torch.Generator, n: int, h: int, w: int, device) -> torch.Tensor:
    """[n, 3, h, w] float32 radiance."""
    yy = (torch.arange(h, device=device, dtype=torch.float32) / h).view(1, 1, h, 1)
    xx = (torch.arange(w, device=device, dtype=torch.float32) / w).view(1, 1, 1, w)
    f = _u(gen, (n, 3, 4, 2), 0.5, 4.0, device)
    ph = _u(gen, (n, 3, 4, 2), 0.0, 2 * math.pi, device)
    amp = _u(gen, (n, 3, 4), 0.1, 0.5, device)
    base = torch.zeros(n, 3, h, w, device=device)
    for k in range(4):
        sy = torch.sin(2 * math.pi * f[:, :, k, 0, None, None] * yy + ph[:, :, k, 0, None, None])
        sx = torch.sin(2 * math.pi * f[:, :, k, 1, None, None] * xx + ph[:, :, k, 1, None, None])
        base += amp[:, :, k, None, None] * sy * sx
    img = torch.exp(base)
    c = _u(gen, (n, N_SHAPES, 2), 0.0, 1.0, device)
    r = _u(gen, (n, N_SHAPES, 2), 0.03, 0.25, device)
    albedo = _u(gen, (n, N_SHAPES, 3), 0.05, 1.5, device) * _u(gen, (n, N_SHAPES, 1), 0.5, 2.0, device)
    rect = torch.rand((n, N_SHAPES), generator=gen, device=device) < 0.5
    for s in range(N_SHAPES):
        dy = (yy - c[:, s, 0].view(n, 1, 1, 1)) / r[:, s, 0].view(n, 1, 1, 1)
        dx = (xx - c[:, s, 1].view(n, 1, 1, 1)) / r[:, s, 1].view(n, 1, 1, 1)
        m = torch.where(rect[:, s].view(n, 1, 1, 1), (dy.abs() < 1) & (dx.abs() < 1), dy * dy + dx * dx < 1)
        img = torch.where(m, img * 0.3 + albedo[:, s].view(n, 3, 1, 1), img)
    c = _u(gen, (n, N_EMITTERS, 2), 0.1, 0.9, device)
    r = _u(gen, (n, N_EMITTERS, 2), 0.02, 0.12, device)
    level = _u(gen, (n, N_EMITTERS, 1), 8.0, 60.0, device) * _u(gen, (n, N_EMITTERS, 3), 0.7, 1.0, device)
    glow = _u(gen, (n, N_EMITTERS), 0.5, 2.0, device)
    for e in range(N_EMITTERS):
        dy = (yy - c[:, e, 0].view(n, 1, 1, 1)) / r[:, e, 0].view(n, 1, 1, 1)
        dx = (xx - c[:, e, 1].view(n, 1, 1, 1)) / r[:, e, 1].view(n, 1, 1, 1)
        d2 = dy * dy + dx * dx
        img = torch.where(d2 < 1, level[:, e].view(n, 3, 1, 1), img)
        img = img + torch.exp(-4.0 * d2 / 9.0) * glow[:, e].view(n, 1, 1, 1)
    return img


def tone_map_u8(hdr: torch.Tensor) -> torch.Tensor:
    """[n, 3, h, w] radiance -> [n, h, w, 3] uint8: mean to 0.5, gamma 2.2."""
    x = hdr * (0.5 / hdr.mean(dim=(1, 2, 3), keepdim=True))
    x = torch.clamp(x, 0.0, 1.0) ** (1.0 / 2.2)
    return torch.round(x * 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def ldr_images(gen: torch.Generator, n: int, h: int, w: int, device, chunk: int = 64) -> np.ndarray:
    """[n, h, w, 3] uint8 RGB on the host."""
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(0, n, chunk):
        k = min(chunk, n - i)
        out[i:i + k] = tone_map_u8(hdr_scenes(gen, k, h, w, device)).cpu().numpy()
    return out
