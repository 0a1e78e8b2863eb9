"""Sharded binary record files for HDR-Real patch pairs (tfrecord replacement;
the port's copy of ``singlehdr_tpu.data.records``, which writes the same bytes).

The reference stores paired 256^2 HDR/LDR patches as GZIP tfrecords, 32
examples per shard (convert_to_tf_record.py:12-14,44-48), parsed back with
tf.io (finetune_real_dataset.py:34-61).  This framework uses its own
dependency-free format:

  ``<name>.shdrec``  SHDR1 magic, then per record: [u32 payload_len][zlib blob]
                     where the payload is  u16 h | u16 w | f32 hdr[h,w,3] |
                     u8 ldr[h,w,3]  (little-endian, C order)
  ``<name>.idx``     u64 byte offsets of each record (enables O(1) random
                     access and cheap global shuffling across shards)

``convert_hdr_real`` reproduces the reference converter's patching scheme:
stride-64 256^2 patches including border patches, skipping patches whose gray
rendition is >50% over- (>=249) or under-exposed (<=6)
(convert_to_tf_record.py:53-86).
"""

from __future__ import annotations

import glob
import os
import struct
import zlib
from typing import List, Sequence, Tuple

import numpy as np

MAGIC = b"SHDR1\n"
PATCH_SIZE = 256
PATCH_STRIDE = 64
SHARD_RECORDS = 32

_LUMA = np.asarray([0.2989, 0.587, 0.114], np.float32)


def _encode(hdr: np.ndarray, ldr: np.ndarray, level: int = 1) -> bytes:
    h, w, _ = hdr.shape
    payload = (
        struct.pack("<HH", h, w)
        + np.ascontiguousarray(hdr, np.float32).tobytes()
        + np.ascontiguousarray(ldr, np.uint8).tobytes()
    )
    return zlib.compress(payload, level)


def _decode(blob: bytes) -> Tuple[np.ndarray, np.ndarray]:
    payload = zlib.decompress(blob)
    h, w = struct.unpack_from("<HH", payload, 0)
    hdr_n = h * w * 3 * 4
    hdr = np.frombuffer(payload, np.float32, h * w * 3, 4).reshape(h, w, 3)
    ldr = np.frombuffer(payload, np.uint8, h * w * 3, 4 + hdr_n).reshape(h, w, 3)
    return hdr, ldr


class RecordWriter:
    """Writes (hdr f32, ldr u8) pairs into sharded .shdrec files."""

    def __init__(self, out_dir: str, prefix: str = "train", shard_records: int = SHARD_RECORDS):
        os.makedirs(out_dir, exist_ok=True)
        self._dir = out_dir
        self._prefix = prefix
        self._shard_records = shard_records
        self._count = 0
        self._file = None
        self._offsets: List[int] = []
        self._shard_idx = -1

    def _roll(self) -> None:
        self._flush_shard()
        self._shard_idx += 1
        path = os.path.join(self._dir, f"{self._prefix}_{self._shard_idx:04d}.shdrec")
        self._file = open(path, "wb")
        self._file.write(MAGIC)
        self._offsets = []

    def _flush_shard(self) -> None:
        if self._file is not None:
            idx_path = self._file.name[: -len(".shdrec")] + ".idx"
            np.asarray(self._offsets, np.uint64).tofile(idx_path)
            self._file.close()
            self._file = None

    def write(self, hdr: np.ndarray, ldr: np.ndarray) -> None:
        if self._count % self._shard_records == 0:
            self._roll()
        blob = _encode(hdr, ldr)
        self._offsets.append(self._file.tell())
        self._file.write(struct.pack("<I", len(blob)))
        self._file.write(blob)
        self._count += 1

    def close(self) -> None:
        self._flush_shard()

    @property
    def count(self) -> int:
        return self._count

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordDataset:
    """Random-access reader over a directory of .shdrec shards.

    Items are raw (hdr float32 [h,w,3], ldr uint8 [h,w,3]) pairs; normalization
    and augmentation belong to the training pipeline (see ``real.py``).
    """

    def __init__(self, record_dir: str, prefix: str = "train"):
        self._shards = sorted(
            glob.glob(os.path.join(record_dir, f"{prefix}_*.shdrec"))
        )
        if not self._shards:
            raise FileNotFoundError(f"no {prefix}_*.shdrec under {record_dir}")
        self._offsets = [
            np.fromfile(s[: -len(".shdrec")] + ".idx", np.uint64) for s in self._shards
        ]
        counts = [len(o) for o in self._offsets]
        self._cum = np.cumsum([0] + counts)

    def __len__(self) -> int:
        return int(self._cum[-1])

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        shard = int(np.searchsorted(self._cum, idx, side="right") - 1)
        local = idx - int(self._cum[shard])
        with open(self._shards[shard], "rb") as f:
            f.seek(int(self._offsets[shard][local]))
            (n,) = struct.unpack("<I", f.read(4))
            return _decode(f.read(n))


def patch_is_informative(ldr_patch_u8: np.ndarray) -> bool:
    """Keep patches not dominated by extreme exposure
    (convert_to_tf_record.py:53-68)."""
    gray = ldr_patch_u8.astype(np.float32) @ _LUMA
    extreme = int(np.sum(gray >= 249.0)) + int(np.sum(gray <= 6.0))
    return extreme <= gray.size // 2


def iter_patch_origins(h: int, w: int, size: int = PATCH_SIZE, stride: int = PATCH_STRIDE):
    """Stride grid plus border patches (convert_to_tf_record.py:72-86)."""
    ys = list(range(0, h - size + 1, stride))
    xs = list(range(0, w - size + 1, stride))
    for y in ys:
        for x in xs:
            yield y, x
    if h % size:
        for x in xs:
            yield h - size, x
    if w % size:
        for y in ys:
            yield y, w - size
    if w % size and h % size:
        yield h - size, w - size


def convert_hdr_real(
    hdr_paths: Sequence[str],
    ldr_paths: Sequence[str],
    out_dir: str,
    prefix: str = "train",
    log_every: int = 10,
    patch_size: int = PATCH_SIZE,
    patch_stride: int = PATCH_STRIDE,
) -> int:
    """Slice paired full images into filtered 256^2 patch records."""
    from singlehdr_tpu_torch.data.hdr_io import read_hdr, read_ldr

    if len(hdr_paths) != len(ldr_paths):
        raise ValueError("HDR/LDR file lists differ in length")
    with RecordWriter(out_dir, prefix) as w:
        for i, (hp, lp) in enumerate(zip(hdr_paths, ldr_paths)):
            if log_every and i % log_every == 0:
                print(f"[convert] {i}/{len(hdr_paths)}")
            hdr = read_hdr(hp)
            ldr = read_ldr(lp)
            if hdr.shape != ldr.shape:
                raise ValueError(f"shape mismatch {hp} vs {lp}")
            h, wdt, _ = hdr.shape
            for y, x in iter_patch_origins(h, wdt, patch_size, patch_stride):
                lp_patch = ldr[y : y + patch_size, x : x + patch_size]
                if patch_is_informative(lp_patch):
                    w.write(hdr[y : y + patch_size, x : x + patch_size], lp_patch)
        return w.count
