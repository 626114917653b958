"""A small msgpack decoder for the subset that flax's serializer writes.

The card's machine has no ``msgpack`` package, and the port must read the
checkpoints and transfer artifacts that the JAX package writes with
``flax.serialization.msgpack_serialize``. That format is plain msgpack plus two
extension types:

  * ext code 1 (``ndarray``): the payload is itself msgpack,
    ``[shape, dtype_name, raw C-order bytes]``;
  * ext code 3 (``npscalar``): the same payload, returned here as a 0-d array.

Any other extension code raises, as does a byte that starts no known type.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def unpackb(blob: bytes) -> Any:
    """Decode one msgpack object that spans all of ``blob``."""
    obj, end = _decode(memoryview(blob), 0)
    if end != len(blob):
        raise ValueError(f"trailing bytes after msgpack object: {len(blob) - end}")
    return obj


def _decode(buf: memoryview, i: int) -> Tuple[Any, int]:
    b = buf[i]
    i += 1
    if b <= 0x7F:                       # positive fixint
        return b, i
    if b >= 0xE0:                       # negative fixint
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:               # fixmap
        return _map(buf, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:               # fixarray
        return _array(buf, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:               # fixstr
        return _str(buf, i, b & 0x1F)
    if b == 0xC0:
        return None, i
    if b == 0xC2:
        return False, i
    if b == 0xC3:
        return True, i
    if b in _BIN:                       # bin8/16/32
        n, i = _uint(buf, i, _BIN[b])
        return bytes(buf[i:i + n]), i + n
    if b in _EXT:                       # ext8/16/32
        n, i = _uint(buf, i, _EXT[b])
        return _ext(buf, i, n)
    if 0xD4 <= b <= 0xD8:               # fixext 1/2/4/8/16
        return _ext(buf, i, 1 << (b - 0xD4))
    if b == 0xCA:
        return struct.unpack_from(">f", buf, i)[0], i + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, i)[0], i + 8
    if b in _UINT:                      # uint8/16/32/64
        return _uint(buf, i, _UINT[b])
    if b in _INT:                       # int8/16/32/64
        fmt, size = _INT[b]
        return struct.unpack_from(fmt, buf, i)[0], i + size
    if b in _STR:                       # str8/16/32
        n, i = _uint(buf, i, _STR[b])
        return _str(buf, i, n)
    if b in _ARRAY:                     # array16/32
        n, i = _uint(buf, i, _ARRAY[b])
        return _array(buf, i, n)
    if b in _MAP:                       # map16/32
        n, i = _uint(buf, i, _MAP[b])
        return _map(buf, i, n)
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at offset {i - 1}")


_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_UINT = {0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}
_INT = {0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}


def _uint(buf: memoryview, i: int, size: int) -> Tuple[int, int]:
    return int.from_bytes(buf[i:i + size], "big"), i + size


def _str(buf: memoryview, i: int, n: int) -> Tuple[str, int]:
    return bytes(buf[i:i + n]).decode("utf-8"), i + n


def _array(buf: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, i = _decode(buf, i)
        out.append(v)
    return out, i


def _map(buf: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _decode(buf, i)
        v, i = _decode(buf, i)
        out[k] = v
    return out, i


def _ext(buf: memoryview, i: int, n: int) -> Tuple[np.ndarray, int]:
    code = struct.unpack_from(">b", buf, i)[0]
    payload = bytes(buf[i + 1:i + 1 + n])
    if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
        raise ValueError(f"unsupported msgpack extension code {code}")
    shape, dtype_name, raw = unpackb(payload)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)
    return arr.copy(), i + 1 + n
