"""CRC-32C (Castagnoli), the checksum of TensorFlow's tensor bundles
(train/tf1_bundle.py): `crc32c` runs the port's C source
(`native/crc32c.cpp` of this package, built with g++ at its first call);
`crc32c_plain` is its plain Python version, which the tests hold it to.
`mask` is the bundle's masked form of a crc."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ._build import PORT_NATIVE_DIR, load_library

POLY = 0x82F63B78      # reflected Castagnoli polynomial


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The checksum, built and loaded on the first call of the process; a
    failed build raises (there is no fallback)."""
    lib = load_library("crc32c.cpp", "crc32c", root=PORT_NATIVE_DIR)
    lib.udt_crc32c.restype = ctypes.c_uint32
    lib.udt_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t]
    return lib


def crc32c(data, crc: int = 0) -> int:
    """`crc` extended by the bytes of `data` (bytes, bytearray, memoryview or
    a C-contiguous numpy array)."""
    a = data if isinstance(data, np.ndarray) else np.frombuffer(data, np.uint8)
    if not a.flags.c_contiguous:
        raise ValueError("crc32c needs a C-contiguous array")
    return library().udt_crc32c(crc, a.ctypes.data, a.nbytes)


@functools.lru_cache(maxsize=1)
def _table() -> tuple[int, ...]:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        out.append(c)
    return tuple(out)


def crc32c_plain(data, crc: int = 0) -> int:
    """The same checksum, one byte at a time in Python."""
    table = _table()
    c = crc ^ 0xFFFFFFFF
    for byte in memoryview(data).cast("B"):
        c = (c >> 8) ^ table[(c ^ byte) & 0xFF]
    return c ^ 0xFFFFFFFF


def mask(crc: int) -> int:
    """The masked crc that bundles store (leveldb's crc32c::Mask)."""
    return ((((crc >> 15) | (crc << 17)) & 0xFFFFFFFF) + 0xA282EAD8) & 0xFFFFFFFF
