"""Radiance RGBE (.hdr) image IO (the port's copy of ``singlehdr_tpu.data.hdr_io``).

The reference reads/writes .hdr exclusively through cv2 (dataset.py:182,
utils.py:43-48, test_real_refinement.py:154).  We use cv2 when available (its
C++ decoder is fast and releases the GIL) and fall back to a pure-numpy RGBE
codec (RLE-capable) so the framework has no hard native dependency.

Channel order: **this framework is RGB end-to-end at IO boundaries.**  cv2
returns BGR, so reads flip to RGB and writes flip back.  (The reference's
loader performs two mutually-cancelling flips and actually trains on cv2's BGR
order — dataset.py:183-184; a faithful-order mode is not needed because the
nets are trained from scratch here, but weight importers must account for it.)
"""

from __future__ import annotations

import struct

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> float32 RGB [h,w,3], clipped to >= 0."""
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"failed to read HDR image: {path}")
        img = img[:, :, ::-1]  # BGR -> RGB
    else:  # pragma: no cover
        img = _read_rgbe(path)
    return np.clip(np.ascontiguousarray(img, dtype=np.float32), 0.0, None)


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write float32 RGB [h,w,3] to a Radiance .hdr file."""
    rgb = np.asarray(rgb, np.float32)
    if _HAS_CV2:
        ok = cv2.imwrite(path, rgb[:, :, ::-1])
        if not ok:
            raise IOError(f"failed to write HDR image: {path}")
    else:  # pragma: no cover
        _write_rgbe(path, rgb)


def read_ldr(path: str) -> np.ndarray:
    """Read an 8-bit LDR image -> uint8 RGB [h,w,3]."""
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError(f"failed to read LDR image: {path}")
        return np.ascontiguousarray(img[:, :, ::-1])
    from PIL import Image  # pragma: no cover

    return np.asarray(Image.open(path).convert("RGB"))  # pragma: no cover


# --------------------------------------------------------------------------
# Pure-numpy RGBE codec (fallback path; also used by tests to cross-check cv2)
# --------------------------------------------------------------------------


def rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    """float32 RGB [h,w,3] -> uint8 RGBE [h,w,4] (shared-exponent format)."""
    rgb = np.maximum(np.asarray(rgb, np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    out = np.zeros((*rgb.shape[:2], 4), np.uint8)
    nz = maxc >= 1e-32
    # frexp: maxc = m * 2**e with m in [0.5, 1)
    m, e = np.frexp(maxc[nz])
    scale = m * 256.0 / maxc[nz]
    out[nz, :3] = np.clip(np.round(rgb[nz] * scale[:, None]), 0, 255).astype(np.uint8)
    out[nz, 3] = (e + 128).astype(np.uint8)
    return out


def rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    """uint8 RGBE [h,w,4] -> float32 RGB [h,w,3]."""
    rgbe = np.asarray(rgbe, np.uint8)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def _write_rgbe(path: str, rgb: np.ndarray) -> None:
    h, w, _ = rgb.shape
    data = rgbe_encode(rgb)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(data.tobytes())  # flat (non-RLE) scanlines


def _read_rgbe(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#?"):
            raise IOError(f"not a Radiance file: {path}")
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n"):
                break
            if not line:
                raise IOError(f"truncated HDR header: {path}")
        dims = f.readline().split()
        if len(dims) != 4 or dims[0] != b"-Y" or dims[2] != b"+X":
            raise IOError(f"unsupported HDR orientation: {path}")
        h, w = int(dims[1]), int(dims[3])
        payload = f.read()

    rows = []
    pos = 0
    for _ in range(h):
        row, pos = _decode_scanline(payload, pos, w)
        rows.append(row)
    return rgbe_decode(np.stack(rows, axis=0))


def _decode_scanline(buf: bytes, pos: int, w: int):
    """Decode one scanline (new-style RLE or flat)."""
    if w >= 8 and w < 32768 and buf[pos] == 2 and buf[pos + 1] == 2:
        width = struct.unpack(">H", buf[pos + 2 : pos + 4])[0]
        if width == w:
            pos += 4
            row = np.zeros((w, 4), np.uint8)
            for c in range(4):
                x = 0
                while x < w:
                    count = buf[pos]
                    pos += 1
                    if count > 128:  # run
                        row[x : x + count - 128, c] = buf[pos]
                        pos += 1
                        x += count - 128
                    else:  # literal
                        row[x : x + count, c] = np.frombuffer(
                            buf, np.uint8, count, pos
                        )
                        pos += count
                        x += count
            return row, pos
    # flat scanline
    row = np.frombuffer(buf, np.uint8, w * 4, pos).reshape(w, 4)
    return row.copy(), pos + w * 4
