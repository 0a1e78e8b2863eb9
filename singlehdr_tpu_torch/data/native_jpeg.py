"""ctypes binding for the native batch JPEG codec (native/jpeg_batch.cpp); the
port's copy of ``singlehdr_tpu.data.native_jpeg``.

Loads ``libshdr_native.so`` (built by ``make -C native`` at the repo root) and exposes the same
interface as the cv2 fallback in ``data.jpeg``.  The native path talks libjpeg
in JCS_RGB directly — the colorspace TF's adjust_jpeg_quality uses — and runs
the batch on a C++ thread pool with the GIL released for the whole call.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_LIB_ENV = "SINGLEHDR_NATIVE_LIB"
_SEARCH = (
    os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "..", "..", "native", "build", "libshdr_native.so",
    ),
)

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    candidates = [os.environ[_LIB_ENV]] if _LIB_ENV in os.environ else []
    candidates += [os.path.abspath(p) for p in _SEARCH]
    for path in candidates:
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
            lib.shdr_jpeg_roundtrip_batch.restype = ctypes.c_int
            lib.shdr_jpeg_roundtrip_batch.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
            ]
            _lib = lib
            break
        except OSError:
            continue
    return _lib


def available() -> bool:
    return _load() is not None


def jpeg_roundtrip_batch_native(
    rgb_u8: np.ndarray, qualities: Sequence[int], n_threads: int = 0
) -> np.ndarray:
    """[b,h,w,3] uint8 RGB -> round-tripped batch via the native codec."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native codec not built — run `make -C native`")
    if rgb_u8.dtype != np.uint8 or rgb_u8.ndim != 4 or rgb_u8.shape[-1] != 3:
        raise TypeError(f"expected uint8 [b,h,w,3], got {rgb_u8.dtype} {rgb_u8.shape}")
    b, h, w, _ = rgb_u8.shape
    if len(qualities) != b:
        raise ValueError("quality ladder length must equal batch size")
    src = np.ascontiguousarray(rgb_u8)
    out = np.empty_like(src)
    q = np.asarray(qualities, np.int32)
    rc = lib.shdr_jpeg_roundtrip_batch(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b,
        h,
        w,
        q.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_threads),
    )
    if rc != 0:
        raise RuntimeError(f"native JPEG round trip failed (rc={rc})")
    return out
