"""Pure-Python reader/writer for TensorFlow's TensorBundle checkpoint format
(the port's copy of ``singlehdr_tpu.train.tensorbundle``, which writes the
same bytes).

The reference saves weights with ``tf.train.Checkpoint`` (tf_utils.py:149-169),
which serializes to a *TensorBundle*: a ``<prefix>.index`` file in the LevelDB
sorted-table format whose values are ``BundleEntryProto`` records, plus raw
little-endian tensor bytes in ``<prefix>.data-NNNNN-of-MMMMM`` shards.  Both
formats are public and stable (leveldb ``doc/table_format.md``; TF
``tensor_bundle.proto``), so a dependency-free reader is ~300 lines — this
module implements it, letting ``train.weight_import`` ingest real reference
checkpoints in environments without TensorFlow.

Layout summary (little-endian throughout):

  index file  = data blocks... | metaindex block | index block | footer(48B)
  block       = entries | restarts(u32 each) | num_restarts(u32),
                stored as: contents | type(1B: 0=raw, 1=snappy) | masked-crc32c(4B)
  entry       = varint shared_key_len | varint unshared | varint value_len
                | key suffix | value         (prefix-compressed keys)
  footer      = metaindex BlockHandle | index BlockHandle | pad to 40B
                | magic 0xdb4775248b80fb57
  BlockHandle = varint64 offset | varint64 size (size excludes the 5B trailer)

The first index entry (key "") is a BundleHeaderProto (num_shards, endianness,
version); every other entry maps a tensor name to a BundleEntryProto (dtype,
shape, shard_id, offset, size, crc32c of the payload).

The writer emits single-shard, uncompressed bundles (exactly what TF's
BundleWriter produces for these checkpoints) and exists for fixtures and for
exporting this framework's weights in the reference's on-disk format.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np

TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48
_U32 = struct.Struct("<I")

# tensorflow/core/framework/types.proto enum values we support.
DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("<u1"),   # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("<i1"),   # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("?"),    # DT_BOOL
    14: np.dtype("<u2"),  # DT_BFLOAT16 (raw bits; caller may upcast)
    19: np.dtype("<f2"),  # DT_HALF
    23: np.dtype("<u4"),  # DT_UINT32
    24: np.dtype("<u8"),  # DT_UINT64
}
DT_STRING = 7
_NP_TO_DT = {v: k for k, v in DTYPES.items() if k != 14}


# ---------------------------------------------------------------------------
# crc32c (Castagnoli), with TF/leveldb's rotation masking
# ---------------------------------------------------------------------------

def _make_crc_table() -> List[int]:
    poly = 0x82F63B78
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _make_crc_table()


# The JAX copy runs the byte loop below over the whole payload, in Python:
# tens of seconds for a full-width hal checkpoint.  This copy runs it over
# _LANE-byte lanes side by side with numpy and joins the lanes' registers
# with the operator that appends _LANE zero bytes (the CRC register is
# linear over GF(2)); the values are the same.
_LANE = 1024


def _shift_tables(n: int) -> List[List[int]]:
    """Four byte-indexed tables whose XOR applies ``n`` zero bytes to a raw
    CRC register: ``t[0][r & 255] ^ t[1][(r >> 8) & 255] ^ ...``."""
    tbl = np.asarray(_CRC_TABLE, np.uint32)
    regs = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    for _ in range(n):
        regs = tbl[regs & 0xFF] ^ (regs >> 8)
    cols = regs.tolist()
    tables = []
    for byte in range(4):
        t = [0] * 256
        for v in range(1, 256):
            low = v & -v
            t[v] = t[v ^ low] ^ cols[8 * byte + low.bit_length() - 1]
        tables.append(t)
    return tables


_LANE_SHIFT = _shift_tables(_LANE)


def crc32c(data: bytes, crc: int = 0) -> int:
    c = crc ^ 0xFFFFFFFF
    tbl = _CRC_TABLE
    whole = len(data) // _LANE * _LANE if len(data) >= 64 * _LANE else 0
    if whole:
        t0, t1, t2, t3 = _LANE_SHIFT
        cols = np.frombuffer(data, np.uint8, count=whole).reshape(-1, _LANE).T.copy()
        regs = np.zeros(cols.shape[1], np.uint32)
        regs[0] = c
        table = np.asarray(tbl, np.uint32)
        for col in cols:
            regs = table[(regs ^ col) & 0xFF] ^ (regs >> 8)
        lanes = regs.tolist()
        c = lanes[0]
        for r in lanes[1:]:
            c = t0[c & 0xFF] ^ t1[(c >> 8) & 0xFF] ^ t2[(c >> 16) & 0xFF] ^ t3[c >> 24] ^ r
    for b in memoryview(data)[whole:]:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """leveldb stores crcs rotated+offset so crcs of crcs stay well-behaved."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# varints and minimal protobuf wire decoding
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _proto_fields(buf: bytes) -> Iterable[Tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) from a proto message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:  # fixed64
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wire == 5:  # fixed32
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _proto_field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint((field << 3) | wire) + payload


# ---------------------------------------------------------------------------
# snappy block decompression (for compressed tables; TF writes uncompressed)
# ---------------------------------------------------------------------------

def snappy_decompress(data: bytes) -> bytes:
    out_len, pos = _read_varint(data, 0)
    out = bytearray()
    n = len(data)
    while pos < n:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            length = (tag >> 2) + 1
            if length > 60:
                nbytes = length - 60
                length = int.from_bytes(data[pos : pos + nbytes], "little") + 1
                pos += nbytes
            out += data[pos : pos + length]
            pos += length
            continue
        if kind == 1:  # copy, 1-byte offset
            length = ((tag >> 2) & 0x7) + 4
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise ValueError("bad snappy copy offset")
        for _ in range(length):  # may self-overlap; byte-at-a-time is correct
            out.append(out[-offset])
    if len(out) != out_len:
        raise ValueError(f"snappy length mismatch: {len(out)} != {out_len}")
    return bytes(out)


# ---------------------------------------------------------------------------
# leveldb sorted-table reading
# ---------------------------------------------------------------------------

def _read_block(raw: bytes, offset: int, size: int, verify: bool) -> bytes:
    contents = raw[offset : offset + size]
    block_type = raw[offset + size]
    if verify:
        stored = _U32.unpack_from(raw, offset + size + 1)[0]
        if masked_crc32c(raw[offset : offset + size + 1]) != stored:
            raise ValueError(f"block crc mismatch at offset {offset}")
    if block_type == 0:
        return contents
    if block_type == 1:
        return snappy_decompress(contents)
    raise ValueError(f"unknown block type {block_type}")


def _block_entries(block: bytes) -> List[Tuple[bytes, bytes]]:
    if len(block) < 4:
        raise ValueError("block too short")
    num_restarts = _U32.unpack_from(block, len(block) - 4)[0]
    data_end = len(block) - 4 - 4 * num_restarts
    entries: List[Tuple[bytes, bytes]] = []
    key = b""
    pos = 0
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        unshared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos : pos + unshared]
        pos += unshared
        entries.append((key, block[pos : pos + value_len]))
        pos += value_len
    return entries


def read_table(raw: bytes, verify_crc: bool = True) -> List[Tuple[bytes, bytes]]:
    """Parse a leveldb-format sorted table into its (key, value) entries."""
    if len(raw) < _FOOTER_LEN:
        raise ValueError("file too short for a table footer")
    footer = raw[-_FOOTER_LEN:]
    magic = struct.unpack_from("<Q", footer, _FOOTER_LEN - 8)[0]
    if magic != TABLE_MAGIC:
        raise ValueError(f"bad table magic 0x{magic:x}")
    pos = 0
    _, pos = _read_varint(footer, pos)       # metaindex offset (unused)
    _, pos = _read_varint(footer, pos)       # metaindex size
    index_off, pos = _read_varint(footer, pos)
    index_size, pos = _read_varint(footer, pos)
    index = _read_block(raw, index_off, index_size, verify_crc)
    out: List[Tuple[bytes, bytes]] = []
    for _, handle in _block_entries(index):
        hpos = 0
        off, hpos = _read_varint(handle, hpos)
        size, hpos = _read_varint(handle, hpos)
        out.extend(_block_entries(_read_block(raw, off, size, verify_crc)))
    return out


# ---------------------------------------------------------------------------
# bundle protos
# ---------------------------------------------------------------------------

class BundleEntry:
    """Decoded BundleEntryProto (tensor_bundle.proto)."""

    __slots__ = ("dtype", "shape", "shard_id", "offset", "size", "crc32c", "sliced")

    def __init__(self):
        self.dtype = 0
        self.shape: Tuple[int, ...] = ()
        self.shard_id = 0
        self.offset = 0
        self.size = 0
        self.crc32c = 0
        self.sliced = False

    @classmethod
    def parse(cls, buf: bytes) -> "BundleEntry":
        e = cls()
        dims: List[int] = []
        for field, _, val in _proto_fields(buf):
            if field == 1:
                e.dtype = int(val)
            elif field == 2:  # TensorShapeProto
                for f2, _, v2 in _proto_fields(val):
                    if f2 == 2:  # Dim
                        for f3, _, v3 in _proto_fields(v2):
                            if f3 == 1:
                                dims.append(_zigzag_free_i64(int(v3)))
                    # unknown_rank (3) not produced for saved variables
            elif field == 3:
                e.shard_id = int(val)
            elif field == 4:
                e.offset = int(val)
            elif field == 5:
                e.size = int(val)
            elif field == 6:
                e.crc32c = int(val)
            elif field == 7:
                e.sliced = True
        e.shape = tuple(dims)
        return e

    def serialize(self) -> bytes:
        out = bytearray()
        if self.dtype:
            out += _proto_field(1, 0, _write_varint(self.dtype))
        shape = bytearray()
        for d in self.shape:
            dim = _proto_field(1, 0, _write_varint(d))
            shape += _proto_field(2, 2, _write_varint(len(dim)) + dim)
        out += _proto_field(2, 2, _write_varint(len(shape)) + bytes(shape))
        if self.shard_id:
            out += _proto_field(3, 0, _write_varint(self.shard_id))
        if self.offset:
            out += _proto_field(4, 0, _write_varint(self.offset))
        if self.size:
            out += _proto_field(5, 0, _write_varint(self.size))
        if self.crc32c:
            out += _proto_field(6, 5, _U32.pack(self.crc32c))
        return bytes(out)


def _zigzag_free_i64(v: int) -> int:
    """int64 varints are two's-complement, not zigzag; fold the sign."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_header(buf: bytes) -> Dict[str, int]:
    out = {"num_shards": 1, "endianness": 0}
    for field, _, val in _proto_fields(buf):
        if field == 1:
            out["num_shards"] = int(val)
        elif field == 2:
            out["endianness"] = int(val)
    return out


def _serialize_header(num_shards: int) -> bytes:
    # num_shards=1, endianness=LITTLE(0, omitted), version.producer=1
    version = _proto_field(1, 0, _write_varint(1))
    return _proto_field(1, 0, _write_varint(num_shards)) + _proto_field(
        3, 2, _write_varint(len(version)) + version
    )


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _shard_path(prefix: str, shard: int, num_shards: int) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


class BundleReader:
    """Random-access reader over ``<prefix>.index`` + data shards."""

    def __init__(self, prefix: str, verify_crc: bool = True):
        self.prefix = prefix
        with open(prefix + ".index", "rb") as f:
            raw = f.read()
        self._entries: Dict[str, BundleEntry] = {}
        self.header = {"num_shards": 1, "endianness": 0}
        for key, value in read_table(raw, verify_crc):
            if key == b"":
                self.header = _parse_header(value)
            else:
                self._entries[key.decode("utf-8")] = BundleEntry.parse(value)
        if self.header["endianness"] != 0:
            raise ValueError("big-endian bundles are not supported")
        self._verify = verify_crc
        self._shards: Dict[int, bytes] = {}

    def keys(self) -> List[str]:
        return list(self._entries)

    def variable_to_shape_map(self) -> Dict[str, Tuple[int, ...]]:
        return {k: e.shape for k, e in self._entries.items() if e.dtype != DT_STRING}

    def entry(self, key: str) -> BundleEntry:
        return self._entries[key]

    def _shard(self, shard_id: int) -> bytes:
        if shard_id not in self._shards:
            path = _shard_path(self.prefix, shard_id, self.header["num_shards"])
            with open(path, "rb") as f:
                self._shards[shard_id] = f.read()
        return self._shards[shard_id]

    def get_tensor(self, key: str) -> np.ndarray:
        e = self._entries[key]
        if e.dtype == DT_STRING:
            raise ValueError(f"{key} is a string tensor (unsupported)")
        if e.sliced:
            raise ValueError(f"{key} is stored as slices (unsupported)")
        dt = DTYPES.get(e.dtype)
        if dt is None:
            raise ValueError(f"{key}: unsupported dtype enum {e.dtype}")
        raw = self._shard(e.shard_id)[e.offset : e.offset + e.size]
        if len(raw) != e.size:
            raise ValueError(f"{key}: data shard truncated")
        if self._verify and e.crc32c and masked_crc32c(raw) != e.crc32c:
            raise ValueError(f"{key}: tensor payload crc mismatch")
        arr = np.frombuffer(raw, dtype=dt).reshape(e.shape)
        if e.dtype == 14:  # bfloat16 bits -> float32
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        return arr


def read_bundle(prefix: str, verify_crc: bool = True) -> Dict[str, np.ndarray]:
    """Load every non-string tensor of a TensorBundle as {key: ndarray}."""
    reader = BundleReader(prefix, verify_crc)
    out = {}
    for key, entry in reader._entries.items():
        if entry.dtype == DT_STRING or entry.sliced:
            continue
        out[key] = reader.get_tensor(key)
    return out


def is_bundle(path: str) -> bool:
    """True if ``path`` looks like a TensorBundle checkpoint prefix."""
    return os.path.exists(path + ".index") or bool(
        re.search(r"\.index$", path) and os.path.exists(path)
    )


# ---------------------------------------------------------------------------
# writer (single shard, uncompressed — matches TF's BundleWriter output)
# ---------------------------------------------------------------------------


class _BlockBuilder:
    """leveldb BlockBuilder with prefix compression (restart interval 16)."""

    def __init__(self, restart_interval: int = 16):
        self._buf = bytearray()
        self._restarts = [0]
        self._last_key = b""
        self._count = 0
        self._interval = restart_interval

    def add(self, key: bytes, value: bytes) -> None:
        if self._count >= self._interval:
            self._restarts.append(len(self._buf))
            self._last_key = b""
            self._count = 0
        shared = 0
        maxlen = min(len(key), len(self._last_key))
        while shared < maxlen and key[shared] == self._last_key[shared]:
            shared += 1
        self._buf += _write_varint(shared)
        self._buf += _write_varint(len(key) - shared)
        self._buf += _write_varint(len(value))
        self._buf += key[shared:]
        self._buf += value
        self._last_key = key
        self._count += 1

    def finish(self) -> bytes:
        out = bytes(self._buf)
        for r in self._restarts:
            out += _U32.pack(r)
        return out + _U32.pack(len(self._restarts))


def _emit_block(out: bytearray, contents: bytes) -> bytes:
    """Append contents + trailer; return the varint-encoded BlockHandle."""
    offset = len(out)
    out += contents
    out += b"\x00"  # kNoCompression
    out += _U32.pack(masked_crc32c(contents + b"\x00"))
    return _write_varint(offset) + _write_varint(len(contents))


def write_bundle(prefix: str, tensors: Mapping[str, np.ndarray]) -> None:
    """Write {key: array} as a single-shard TensorBundle at ``prefix``.

    Keys are sorted as TF does; float64/float32/int arrays pass through with
    their native dtypes.  Readable by ``tf.train.load_checkpoint`` and by
    ``BundleReader`` above.
    """
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    data = bytearray()
    index_entries: List[Tuple[bytes, bytes]] = [(b"", _serialize_header(1))]
    for key in sorted(tensors):
        value = tensors[key]
        if isinstance(value, (bytes, bytearray)):
            # DT_STRING scalar (e.g. _CHECKPOINTABLE_OBJECT_GRAPH).  TF's
            # on-disk string-tensor layout, confirmed against TF-2.21-written
            # bundles: varint64 length per element, then a masked crc32c of
            # the lengths *as little-endian uint32s* (not the varint bytes),
            # then the concatenated string bytes.
            u32_len = struct.pack("<I", len(value))
            len_crc = _U32.pack(masked_crc32c(u32_len))
            payload = _write_varint(len(value)) + len_crc + bytes(value)
            e = BundleEntry()
            e.dtype = DT_STRING
            e.shape = ()
            e.offset = len(data)
            e.size = len(payload)
            # the entry checksum runs over the *u32* form of the lengths,
            # then the inner crc bytes, then the data (confirmed against
            # TF-2.21-written bundles)
            e.crc32c = masked_crc32c(u32_len + len_crc + bytes(value))
            data += payload
            index_entries.append((key.encode("utf-8"), e.serialize()))
            continue
        arr = np.asarray(value)
        if arr.ndim:  # ascontiguousarray promotes 0-d arrays to 1-d
            arr = np.ascontiguousarray(arr)
        if arr.dtype == np.float16:
            dt = 19
        elif arr.dtype.newbyteorder("<") not in _NP_TO_DT:
            arr = arr.astype(np.float32)
            dt = 1
        else:
            dt = _NP_TO_DT[arr.dtype.newbyteorder("<")]
        payload = arr.astype(arr.dtype.newbyteorder("<"), copy=False).tobytes()
        e = BundleEntry()
        e.dtype = dt
        e.shape = tuple(int(d) for d in arr.shape)
        e.offset = len(data)
        e.size = len(payload)
        e.crc32c = masked_crc32c(payload)
        data += payload
        index_entries.append((key.encode("utf-8"), e.serialize()))

    # one data block holding every index entry, then metaindex + index blocks
    table = bytearray()
    bb = _BlockBuilder()
    for k, v in index_entries:
        bb.add(k, v)
    data_handle = _emit_block(table, bb.finish())
    meta_handle = _emit_block(table, _BlockBuilder().finish())
    ib = _BlockBuilder()
    # index key only needs to be >= every key in the block
    last_key = index_entries[-1][0]
    ib.add(last_key + b"\x00", data_handle)
    index_handle = _emit_block(table, ib.finish())
    footer = meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", TABLE_MAGIC)
    table += footer

    with open(prefix + ".index", "wb") as f:
        f.write(table)
    with open(_shard_path(prefix, 0, 1), "wb") as f:
        f.write(data)
