"""Host-side JPEG round-trip for the degradation simulator (the port's copy of
``singlehdr_tpu.data.jpeg``).

The reference runs tf.image.adjust_jpeg_quality per sample on the host
(train.py:51-59).  Here the
batch round-trip runs through libjpeg(-turbo) via cv2 on a thread pool —
cv2.imencode/imdecode release the GIL, so samples compress in parallel — and
the input loader overlaps it with device compute.

A native C++ batch codec (``native/``) can replace this when present; the
Python/cv2 path is the always-available fallback with identical semantics.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

try:  # cv2 is present in the target image; without it and the native codec, raise
    import cv2

    cv2.setNumThreads(0)  # avoid oversubscription under our own pool
    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

_POOL: ThreadPoolExecutor | None = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=16, thread_name_prefix="jpeg")
    return _POOL


def _roundtrip_one(rgb_u8: np.ndarray, quality: int) -> np.ndarray:
    # cv2 operates in BGR; flip for correct chroma handling, flip back after.
    bgr = rgb_u8[..., ::-1]
    ok, buf = cv2.imencode(".jpg", bgr, [int(cv2.IMWRITE_JPEG_QUALITY), int(quality)])
    if not ok:  # pragma: no cover
        raise RuntimeError("JPEG encode failed")
    dec = cv2.imdecode(buf, cv2.IMREAD_COLOR)
    return dec[..., ::-1]


def jpeg_roundtrip_batch(
    rgb_u8: np.ndarray, qualities: Sequence[int]
) -> np.ndarray:
    """Compress+decompress each [h,w,3] uint8 sample at its own quality.

    Uses the native C++ libjpeg codec (``native/``, direct JCS_RGB — the same
    colorspace TF's adjust_jpeg_quality uses) when built, else cv2 on a thread
    pool.

    Args:
      rgb_u8: [b,h,w,3] uint8 RGB batch.
      qualities: length-b JPEG quality ladder (see ops.degradation).

    Returns: [b,h,w,3] uint8 RGB batch after the round trip.
    """
    if rgb_u8.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {rgb_u8.dtype}")
    if len(qualities) != rgb_u8.shape[0]:
        raise ValueError("quality ladder length must equal batch size")
    from singlehdr_tpu_torch.data import native_jpeg

    if native_jpeg.available():
        return native_jpeg.jpeg_roundtrip_batch_native(
            np.ascontiguousarray(rgb_u8), qualities
        )
    if not _HAS_CV2:
        raise RuntimeError(
            "no JPEG codec: neither the native libjpeg codec (native/build/libshdr_native.so, "
            "built by `make -C native`) nor cv2 is available, so the JPEG degradation cannot run"
        )
    futs = [
        _pool().submit(_roundtrip_one, rgb_u8[i], q)
        for i, q in enumerate(qualities)
    ]
    return np.stack([f.result() for f in futs], axis=0)
