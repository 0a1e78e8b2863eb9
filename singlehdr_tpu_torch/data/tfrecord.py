"""Dependency-free reader/writer for the reference's GZIP TFRecord shards (the
port's copy of ``singlehdr_tpu.data.tfrecord``).

The reference's HDR-Real finetune data ships as GZIP-compressed TFRecord
files of ``tf.train.Example`` protos with two bytes features — ``ref_HDR``
(raw float32 [256,256,3], RGB) and ``ref_LDR`` (raw float32 0..255, RGB) —
written 32 examples/shard (convert_to_tf_record.py:7,12-14,44-48,60-65) and
parsed back with tf.io (finetune_real_dataset.py:34-48).  Anyone holding
that data should be able to feed this framework without the original
``.hdr``/``.jpg`` sources, so this module implements just enough of the two
formats involved, with no TF dependency:

  * TFRecord framing: ``u64 len | u32 masked_crc32c(len) | payload |
    u32 masked_crc32c(payload)`` per record, whole file wrapped in one gzip
    stream when the GZIP option is used.
  * Protobuf wire format for Example -> Features -> map<string, Feature> ->
    BytesList — a ~60-line varint/length-delimited parser that skips
    unknown fields, and the mirror-image writer.

Reading verifies the length CRC (cheap, catches framing desync); payload
CRCs are verified when ``verify=True`` (pure-Python CRC32C runs ~5 MB/s, so
the default trusts gzip's own integrity check instead).  Writing always
emits correct CRCs so TF-side readers accept the output.
"""

from __future__ import annotations

import glob
import gzip
import io
import os
import struct
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven; masked per TFRecord convention.

_CRC_TABLE = None


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.zeros(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table[i] = c
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Protobuf wire helpers (only what Example needs: varint + length-delimited).


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes, int]]:
    """Yield (field_no, wire_type, payload-or-b'', varint_value)."""
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:                      # varint
            val, pos = _read_varint(buf, pos)
            yield field, wt, b"", val
        elif wt == 2:                    # length-delimited
            n, pos = _read_varint(buf, pos)
            yield field, wt, buf[pos: pos + n], 0
            pos += n
        elif wt == 5:                    # 32-bit
            yield field, wt, buf[pos: pos + 4], 0
            pos += 4
        elif wt == 1:                    # 64-bit
            yield field, wt, buf[pos: pos + 8], 0
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")


def parse_example(payload: bytes) -> Dict[str, bytes]:
    """Serialized tf.train.Example -> {feature name: first bytes value}.

    Example.features = field 1; Features.feature (map) = field 1; a map
    entry is a message with key=1, value=2; Feature.bytes_list = field 1;
    BytesList.value = repeated field 1.  Non-bytes features are skipped.
    """
    out: Dict[str, bytes] = {}
    for f, wt, features, _ in _iter_fields(payload):
        if f != 1 or wt != 2:
            continue
        for f2, wt2, entry, _ in _iter_fields(features):
            if f2 != 1 or wt2 != 2:
                continue
            key, feature = None, None
            for f3, wt3, val, _ in _iter_fields(entry):
                if f3 == 1 and wt3 == 2:
                    key = val.decode("utf-8")
                elif f3 == 2 and wt3 == 2:
                    feature = val
            if key is None or feature is None:
                continue
            for f4, wt4, blist, _ in _iter_fields(feature):
                if f4 != 1 or wt4 != 2:  # bytes_list only
                    continue
                for f5, wt5, val, _ in _iter_fields(blist):
                    if f5 == 1 and wt5 == 2:
                        out[key] = val
                        break
    return out


def build_example(features: Dict[str, bytes]) -> bytes:
    """{name: bytes} -> serialized tf.train.Example (bytes features only)."""

    def _ld(out: bytearray, field: int, payload: bytes) -> None:
        _write_varint(out, field << 3 | 2)
        _write_varint(out, len(payload))
        out.extend(payload)

    fmap = bytearray()
    for key, value in features.items():
        blist = bytearray()
        _ld(blist, 1, value)             # BytesList.value
        feat = bytearray()
        _ld(feat, 1, bytes(blist))       # Feature.bytes_list
        entry = bytearray()
        _ld(entry, 1, key.encode("utf-8"))
        _ld(entry, 2, bytes(feat))
        _ld(fmap, 1, bytes(entry))       # Features.feature map entry
    example = bytearray()
    _ld(example, 1, bytes(fmap))         # Example.features
    return bytes(example)


# ---------------------------------------------------------------------------
# TFRecord framing over a (possibly gzip-wrapped) stream.


def iter_tfrecord(path: str, verify: bool = False) -> Iterator[bytes]:
    """Yield record payloads from a TFRecord file (GZIP or plain)."""
    with open(path, "rb") as raw:
        magic = raw.read(2)
        raw.seek(0)
        stream = gzip.GzipFile(fileobj=raw) if magic == b"\x1f\x8b" else raw
        while True:
            header = stream.read(12)
            if not header:
                return
            if len(header) < 12:
                raise ValueError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:])
            if masked_crc(header[:8]) != len_crc:
                raise ValueError(f"{path}: length CRC mismatch")
            payload = stream.read(length)
            (crc,) = struct.unpack("<I", stream.read(4))
            if verify and masked_crc(payload) != crc:
                raise ValueError(f"{path}: payload CRC mismatch")
            yield payload


def write_tfrecord(path: str, payloads: Sequence[bytes],
                   compress: bool = True) -> None:
    """Write record payloads with TFRecord framing (+ gzip when compress)."""
    buf = io.BytesIO()
    for payload in payloads:
        header = struct.pack("<Q", len(payload))
        buf.write(header)
        buf.write(struct.pack("<I", masked_crc(header)))
        buf.write(payload)
        buf.write(struct.pack("<I", masked_crc(payload)))
    data = buf.getvalue()
    if compress:
        data = gzip.compress(data)
    with open(path, "wb") as f:
        f.write(data)


# ---------------------------------------------------------------------------
# The reference's HDR-Real dataset on top of the above.

IMSHAPE = (256, 256, 3)  # finetune_real_dataset.py:27


class TfrecordExampleDataset:
    """Random-access (hdr f32, ldr u8) pairs from reference GZIP shards.

    Shards are gzip streams, so random access within a shard re-streams it
    to the target record; a small decoded-shard cache (~50 MB/shard at the
    reference geometry) covers the common shuffled-epoch access pattern.
    Items match data.records.RecordDataset: ``(hdr float32 [h,w,3] RGB,
    ldr uint8 [h,w,3] RGB)`` — the reference stores the LDR as float32
    0..255 (convert_to_tf_record.py:34,63); values are integral so the u8
    cast is exact and the pipeline's /255 matches
    finetune_real_dataset.py:48.
    """

    def __init__(self, record_dir: str, pattern: str = "*.tfrecords",
                 shape: Tuple[int, int, int] = None, cache_shards: int = 2):
        self._shards = sorted(glob.glob(os.path.join(record_dir, pattern)))
        if not self._shards:
            raise FileNotFoundError(f"no {pattern} under {record_dir}")
        counts = [sum(1 for _ in iter_tfrecord(s)) for s in self._shards]
        self._cum = np.cumsum([0] + counts)
        self._shape = shape
        self._cache: "dict[int, List[Tuple[np.ndarray, np.ndarray]]]" = {}
        self._cache_order: List[int] = []
        self._cache_shards = cache_shards

    def __len__(self) -> int:
        return int(self._cum[-1])

    def _decode(self, payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
        feats = parse_example(payload)
        hdr = np.frombuffer(feats["ref_HDR"], np.float32)
        ldr = np.frombuffer(feats["ref_LDR"], np.float32)
        shape = self._shape
        if shape is None:  # square 3-channel patch: infer the side
            side = int(round((hdr.size / 3) ** 0.5))
            if side * side * 3 != hdr.size:
                shape = IMSHAPE  # the reference geometry as a last resort
            else:
                shape = (side, side, 3)
        return hdr.reshape(shape), ldr.reshape(shape).astype(np.uint8)

    def _shard_records(self, shard: int) -> List[Tuple[np.ndarray, np.ndarray]]:
        if shard in self._cache:
            return self._cache[shard]
        records = [self._decode(p) for p in iter_tfrecord(self._shards[shard])]
        self._cache[shard] = records
        self._cache_order.append(shard)
        while len(self._cache_order) > self._cache_shards:
            self._cache.pop(self._cache_order.pop(0), None)
        return records

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        shard = int(np.searchsorted(self._cum, idx, side="right") - 1)
        return self._shard_records(shard)[idx - int(self._cum[shard])]


def write_reference_shards(
    out_dir: str,
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    records_per_shard: int = 32,
    prefix: str = "train_64",
) -> List[str]:
    """Write (hdr f32, ldr u8-or-f32) pairs as reference-format GZIP shards
    (convert_to_tf_record.py:12-14,23,44-48 naming and layout)."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s in range(0, len(pairs), records_per_shard):
        payloads = []
        for hdr, ldr in pairs[s: s + records_per_shard]:
            payloads.append(
                build_example(
                    {
                        "ref_HDR": np.ascontiguousarray(hdr, np.float32)
                        .tobytes(),
                        "ref_LDR": np.ascontiguousarray(
                            ldr.astype(np.float32)
                        ).tobytes(),
                    }
                )
            )
        path = os.path.join(
            out_dir, f"{prefix}_{s // records_per_shard:04d}.tfrecords"
        )
        write_tfrecord(path, payloads)
        paths.append(path)
    return paths
