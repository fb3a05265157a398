"""TensorFlow's tensor bundle (the TF1 checkpoint format) in numpy and
Python: `read_bundle` stands in for `tf.train.load_checkpoint` and
`write_bundle` for `tf1.train.Saver`, on a host without TensorFlow or a
protobuf package.

A bundle is `<prefix>.index` and its data shards
`<prefix>.data-<shard:05d>-of-<num_shards:05d>`:

* `.index` is a LevelDB table: data blocks of prefix-compressed entries
  (varint shared, non_shared and value lengths, the key suffix, the value;
  then the restart offsets, little-endian uint32, and their count), each
  followed by a compression byte and the masked crc32c of the block and
  that byte; an empty metaindex block; an index block of BlockHandles
  (varint offset and size), one per data block; a 48-byte footer of the
  metaindex and index handles padded to 40 bytes and the magic.
* The key "" holds a `BundleHeaderProto` (num_shards, endianness,
  version); every other key, sorted bytewise, a `BundleEntryProto` (dtype,
  shape, shard_id, offset, size, masked crc32c of the tensor's bytes,
  slices).
* A tensor's bytes lie at `offset` in its shard, row-major.

The writer lays out what TensorFlow's BundleWriter and table builder do:
one shard, tensors in key order without padding, restart points every 16
entries, a new data block once one reaches 256 KiB, index keys shortened
as LevelDB's bytewise comparator shortens them, no compression. Only
float32, int32 and int64 tensors are read or written.
"""

from __future__ import annotations

import os
import struct
from collections.abc import Mapping

import numpy as np

from ..native.crc32c import crc32c, mask

MAGIC = 0xDB4775248B80FB57
FOOTER_BYTES = 48
BLOCK_TRAILER_BYTES = 5
BLOCK_SIZE = 256 * 1024     # TensorFlow's table::Options::block_size
RESTART_INTERVAL = 16
# DataType enum values -> little-endian numpy dtypes
DTYPES = {1: np.dtype("<f4"), 3: np.dtype("<i4"), 9: np.dtype("<i8")}
DTYPE_ENUMS = {v: k for k, v in DTYPES.items()}
HEADER = b"\x08\x01\x1a\x02\x08\x01"    # num_shards 1, version {producer 1}


class BundleError(ValueError):
    """A bundle this reader refuses: damaged, or in a form it does not read."""


# --- protobuf wire format -----------------------------------------------------
def _varint(buf, pos: int) -> tuple[int, int]:
    value = shift = 0
    while True:
        if pos >= len(buf):
            raise BundleError("truncated varint")
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if byte < 0x80:
            return value, pos
        shift += 7


def _put_varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _fields(buf) -> list[tuple[int, int | bytes]]:
    """(field number, value) of a message: an int for the varint and fixed
    wire types, bytes for a length-delimited field."""
    out, pos = [], 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = int.from_bytes(buf[pos:pos + 8], "little"), pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = bytes(buf[pos:pos + n]), pos + n
        elif wire == 5:
            value, pos = int.from_bytes(buf[pos:pos + 4], "little"), pos + 4
        else:
            raise BundleError(f"protobuf wire type {wire} (field {field})")
        if pos > len(buf):
            raise BundleError("truncated protobuf message")
        out.append((field, value))
    return out


def _put_field(field: int, value: int | bytes) -> bytes:
    if isinstance(value, bytes):
        return _put_varint(field << 3 | 2) + _put_varint(len(value)) + value
    return _put_varint(field << 3) + _put_varint(value)


def _entry(name: str, value: bytes) -> dict:
    """A BundleEntryProto's fields; proto3 leaves those at 0 out."""
    entry = {"dtype": 0, "shape": [], "shard_id": 0, "offset": 0, "size": 0, "crc32c": None,
             "sliced": False}
    for field, v in _fields(value):
        if field == 1:
            entry["dtype"] = v
        elif field == 2:
            for f, dim in _fields(v):
                if f == 3 and dim:
                    raise BundleError(f"variable {name!r}: shape of unknown rank")
                if f == 2:
                    entry["shape"].append(dict(_fields(dim)).get(1, 0))
        elif field in (3, 4, 5):
            entry[("shard_id", "offset", "size")[field - 3]] = v
        elif field == 6:
            entry["crc32c"] = v
        elif field == 7:
            entry["sliced"] = True
    return entry


def _entry_bytes(dtype: int, shape, offset: int, size: int, crc: int) -> bytes:
    dims = b"".join(_put_field(2, _put_field(1, d) if d else b"") for d in shape)
    out = _put_field(1, dtype) + _put_field(2, dims)
    if offset:
        out += _put_field(4, offset)
    if size:
        out += _put_field(5, size)
    return out + _put_varint(6 << 3 | 5) + struct.pack("<I", crc)


# --- the LevelDB table --------------------------------------------------------
def _block(index: bytes, offset: int, size: int, what: str) -> memoryview:
    """The contents of the block at (offset, size), its trailer checked."""
    end = offset + size
    if end + BLOCK_TRAILER_BYTES > len(index):
        raise BundleError(f"{what}: block at {offset} runs past the end of the index")
    kind = index[end]
    if kind != 0:
        raise BundleError(f"{what}: block at {offset} is compressed (type {kind}), "
                          "which this reader does not decode")
    (stored,) = struct.unpack_from("<I", index, end + 1)
    if mask(crc32c(index[offset:end + 1])) != stored:
        raise BundleError(f"{what}: crc32c mismatch in the block at {offset}")
    return memoryview(index)[offset:end]


def _block_entries(block: memoryview):
    """(key, value) of a block's prefix-compressed entries."""
    (n_restarts,) = struct.unpack_from("<I", block, len(block) - 4)
    limit = len(block) - 4 - 4 * n_restarts
    pos, key = 0, b""
    while pos < limit:
        shared, pos = _varint(block, pos)
        non_shared, pos = _varint(block, pos)
        n_value, pos = _varint(block, pos)
        key = key[:shared] + bytes(block[pos:pos + non_shared])
        pos += non_shared
        yield key, block[pos:pos + n_value]
        pos += n_value


def _handle(value) -> tuple[int, int]:
    offset, pos = _varint(value, 0)
    size, _ = _varint(value, pos)
    return offset, size


def _data_blocks(index: bytes, path: str) -> list[tuple[bytes, int, int]]:
    """(index key, offset, size) of every data block the table's index
    block names, in order."""
    if len(index) < FOOTER_BYTES:
        raise BundleError(f"{path}: {len(index)} bytes, shorter than a table footer")
    footer = index[-FOOTER_BYTES:]
    if struct.unpack_from("<Q", footer, 40)[0] != MAGIC:
        raise BundleError(f"{path}: not a TensorFlow table (bad magic)")
    _, pos = _varint(footer, _varint(footer, 0)[1])          # skip the metaindex handle
    index_block = _block(index, *_handle(footer[pos:]), what=f"{path} index block")
    return [(key, *_handle(value)) for key, value in _block_entries(index_block)]


def _table(index: bytes, path: str):
    """(key, value) of every entry of every data block of the table."""
    for key, offset, size in _data_blocks(index, path):
        data = _block(index, offset, size,
                      what=f"{path} (the data block before key {key.decode()!r})")
        yield from _block_entries(data)


def _separator(start: bytes, limit: bytes) -> bytes:
    """LevelDB's BytewiseComparator::FindShortestSeparator."""
    n = min(len(start), len(limit))
    i = next((k for k in range(n) if start[k] != limit[k]), n)
    if i < n and start[i] < 0xFF and start[i] + 1 < limit[i]:
        return start[:i] + bytes([start[i] + 1])
    return start


def _successor(key: bytes) -> bytes:
    """LevelDB's BytewiseComparator::FindShortSuccessor."""
    for i, byte in enumerate(key):
        if byte != 0xFF:
            return key[:i] + bytes([byte + 1])
    return key


class _BlockBuilder:
    def __init__(self, restart_interval: int):
        self.interval = restart_interval
        self.reset()

    def reset(self) -> None:
        self.buf, self.restarts, self.count, self.last = bytearray(), [0], 0, b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.count < self.interval:
            n = min(len(self.last), len(key))
            while shared < n and self.last[shared] == key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.count = 0
        self.buf += (_put_varint(shared) + _put_varint(len(key) - shared)
                     + _put_varint(len(value)) + key[shared:] + value)
        self.last, self.count = key, self.count + 1

    def size(self) -> int:
        return len(self.buf) + 4 * len(self.restarts) + 4

    def finish(self) -> bytes:
        return bytes(self.buf + struct.pack(f"<{len(self.restarts)}I", *self.restarts)
                     + struct.pack("<I", len(self.restarts)))


def _table_bytes(entries) -> bytes:
    """A table of (key, value) entries in key order."""
    out = bytearray()
    data, index = _BlockBuilder(RESTART_INTERVAL), _BlockBuilder(1)

    def emit(contents: bytes) -> bytes:
        handle = _put_varint(len(out)) + _put_varint(len(contents))
        out.extend(contents + b"\x00" + struct.pack("<I", mask(crc32c(contents + b"\x00"))))
        return handle

    pending = None      # (last key, handle) of a data block awaiting its index entry
    for key, value in entries:
        if pending is not None:
            index.add(_separator(pending[0], key), pending[1])
            pending = None
        data.add(key, value)
        if data.size() >= BLOCK_SIZE:
            pending = (key, emit(data.finish()))
            data.reset()
    if data.count:
        pending = (data.last, emit(data.finish()))
    if pending is not None:
        index.add(_successor(pending[0]), pending[1])
    meta_handle = emit(_BlockBuilder(RESTART_INTERVAL).finish())
    index_handle = emit(index.finish())
    footer = (meta_handle + index_handle).ljust(FOOTER_BYTES - 8, b"\x00")
    return bytes(out + footer + struct.pack("<Q", MAGIC))


# --- bundles ------------------------------------------------------------------
def data_path(prefix: str, shard: int = 0, num_shards: int = 1) -> str:
    return f"{prefix}.data-{shard:05d}-of-{num_shards:05d}"


def read_bundle(prefix: str) -> dict[str, np.ndarray]:
    """{variable name: array} of every tensor of the bundle at `prefix`,
    each checked against its crc32c. Raises BundleError, naming the
    variable, on a compressed block, big-endian data, a dtype other than
    float32, int32 or int64, a sliced (partitioned) variable or a crc
    mismatch; OSError when a file is missing."""
    with open(prefix + ".index", "rb") as fh:
        index = fh.read()
    entries = dict(_table(index, prefix + ".index"))
    header = dict(_fields(entries.pop(b"", b"")))
    num_shards, big_endian = header.get(1, 1), header.get(2, 0) == 1
    shards: dict[int, np.ndarray] = {}
    out = {}
    for key, value in entries.items():
        name = key.decode()
        e = _entry(name, value)
        if big_endian:
            raise BundleError(f"variable {name!r}: the bundle's data is big-endian")
        if e["sliced"]:
            raise BundleError(f"variable {name!r} is sliced (a partitioned variable)")
        if e["dtype"] not in DTYPES:
            raise BundleError(f"variable {name!r}: dtype enum {e['dtype']} is not float32, "
                              "int32 or int64")
        dtype = DTYPES[e["dtype"]]
        if e["size"] != int(np.prod(e["shape"])) * dtype.itemsize:
            raise BundleError(f"variable {name!r}: {e['size']} bytes for shape {e['shape']}")
        shard = e["shard_id"]
        if shard not in shards:
            shards[shard] = np.fromfile(data_path(prefix, shard, num_shards), dtype=np.uint8)
        raw = shards[shard][e["offset"]:e["offset"] + e["size"]]
        if raw.size != e["size"]:
            raise BundleError(f"variable {name!r}: its bytes run past the end of shard {shard}")
        if e["crc32c"] is not None and mask(crc32c(raw)) != e["crc32c"]:
            raise BundleError(f"variable {name!r}: crc32c mismatch in its data")
        out[name] = raw.view(dtype).reshape(e["shape"])
    return out


def write_bundle(prefix: str, tensors: Mapping[str, np.ndarray]) -> str:
    """Write `tensors` ({variable name: float32, int32 or int64 array}) as a
    one-shard bundle at `prefix` that TensorFlow reads; each file goes
    through a temporary file renamed into place, the index last. Returns
    `prefix`."""
    names = sorted(tensors, key=lambda n: n.encode())
    arrays, entries, offset = [], [(b"", HEADER)], 0
    for name in names:
        if not name:
            raise ValueError("a variable needs a name")
        a = np.asarray(tensors[name])
        dtype = a.dtype.newbyteorder("<")
        if dtype not in DTYPE_ENUMS:
            raise ValueError(f"variable {name!r}: dtype {a.dtype} is not float32, int32 "
                             "or int64")
        a = np.asarray(a, dtype=dtype, order="C")    # keeps a scalar 0-d
        arrays.append(a)
        entries.append((name.encode(), _entry_bytes(DTYPE_ENUMS[dtype], a.shape, offset,
                                                     a.nbytes, mask(crc32c(a)))))
        offset += a.nbytes
    index = _table_bytes(entries)
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    _write_replacing(data_path(prefix), [a.data for a in arrays])
    _write_replacing(prefix + ".index", [index])
    return prefix


def _write_replacing(path: str, chunks) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        for chunk in chunks:
            fh.write(chunk)
    os.replace(tmp, path)
