"""The training feed's deterministic stages, recomputed from the exposed
radiance: clip, the camera curve (a per-sample LUT), 8-bit quantisation,
the host JPEG round trip at the batch's quality ladder and the loss mask
(the reference's train.py:51-70)."""

from __future__ import annotations

import numpy as np
import torch

from hdrbench.reference.nets import apply_rf

LUMA = (0.2989, 0.587, 0.114)
MASK_BUDGET = 256.0 * 256.0 * 0.5


def quality_ladder(b: int) -> list:
    """JPEG qualities 90..100 over the batch."""
    return [90] if b == 1 else [int(round(i / (b - 1) * 10.0 + 90.0)) for i in range(b)]


def jpeg_roundtrip(levels_u8: np.ndarray, qualities) -> np.ndarray:
    """[b, h, w, 3] uint8 RGB through cv2's JPEG at each sample's quality."""
    import cv2

    out = np.empty_like(levels_u8)
    for i, q in enumerate(qualities):
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(levels_u8[i, ..., ::-1]),
                               [int(cv2.IMWRITE_JPEG_QUALITY), int(q)])
        if not ok:
            raise RuntimeError("JPEG encode failed")
        out[i] = cv2.imdecode(buf, cv2.IMREAD_COLOR)[..., ::-1]
    return out


def loss_mask(levels: torch.Tensor) -> torch.Tensor:
    """[b, 3, h, w] 8-bit levels -> [b, 1, 1, 1]: 0 where more than half of a
    256^2 patch's gray levels are >= 249 or <= 6."""
    x = levels.float()
    gray = torch.round(LUMA[0] * x[:, 0] + LUMA[1] * x[:, 1] + LUMA[2] * x[:, 2])
    over = (gray >= 249.0).float().sum(dim=(1, 2))
    under = (gray <= 6.0).float().sum(dim=(1, 2))
    return (~((over > MASK_BUDGET) | (under > MASK_BUDGET))).float().view(-1, 1, 1, 1)


def feed_batch(hdr_t: torch.Tensor, crf: torch.Tensor, invcrf: torch.Tensor) -> dict:
    """The step inputs from the exposed, noised radiance ``hdr_t`` and the
    sample's camera curve and its inverse."""
    clipped = torch.clamp(hdr_t, 0.0, 1.0)
    ldr = apply_rf(clipped, crf)
    levels = torch.round(ldr * 255.0).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    coded = jpeg_roundtrip(levels, quality_ladder(hdr_t.shape[0]))
    jpeg = torch.from_numpy(coded).to(hdr_t.device).permute(0, 3, 1, 2).contiguous()
    return {"ldr": ldr, "jpeg": jpeg.float() / 255.0, "clipped_hdr_t": clipped, "hdr_t": hdr_t,
            "mask": loss_mask(jpeg), "invcrf": invcrf}
