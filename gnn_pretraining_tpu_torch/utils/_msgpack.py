"""A small msgpack codec for the subset that flax's serializer writes.

The card's machine has no ``msgpack`` package, and the port must read the
checkpoints and transfer artifacts that the JAX package writes with
``flax.serialization.msgpack_serialize``, and write checkpoints that
``msgpack_restore`` reads. That format is plain msgpack plus two extension
types:

  * ext code 1 (``ndarray``): the payload is itself msgpack,
    ``[shape, dtype_name, raw C-order bytes]``;
  * ext code 3 (``npscalar``): the same payload, returned here as a 0-d array.

Any other extension code raises, as does a byte that starts no known type.
``packb`` writes dicts with string keys, lists, str, bool, None, int, float
(as float64), bytes, numpy arrays (ext 1) and numpy scalars (ext 3).
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


def packb(obj: Any) -> bytes:
    """Encode ``obj`` as one msgpack object, arrays in flax's extension."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _head(out: bytearray, n: int, fix, codes) -> None:
    """A length header: the fix form when it fits, else the 8/16/32-bit code."""
    if fix is not None and n <= fix[1]:
        out.append(fix[0] | n)
        return
    for code, size in codes:
        if n < 1 << (8 * size):
            out.append(code)
            out += n.to_bytes(size, "big")
            return
    raise ValueError(f"object of length {n} is too long for msgpack")


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, (bool, np.bool_)):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj + 0x100)
        elif obj >= 0:                       # the smallest unsigned form
            code, size = next((c, n) for c, n in _UINT.items() if obj < 1 << (8 * n))
            out.append(code)
            out += obj.to_bytes(size, "big")
        else:                                # the smallest signed form
            code, (fmt, size) = next(
                (c, f) for c, f in _INT.items() if obj >= -(1 << (8 * f[1] - 1)))
            out.append(code)
            out += struct.pack(fmt, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), (0xA0, 31), ((0xD9, 1), (0xDA, 2), (0xDB, 4)))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        _head(out, len(obj), None, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))
        out += obj
    elif isinstance(obj, dict):
        _head(out, len(obj), (0x80, 15), ((0xDE, 2), (0xDF, 4)))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack map key must be str, got {type(k)}")
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), (0x90, 15), ((0xDC, 2), (0xDD, 4)))
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, (np.ndarray, np.generic)):
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        arr = np.asarray(obj)               # tobytes() is C order whatever the strides
        payload = packb([list(arr.shape), arr.dtype.name, arr.tobytes()])
        _head(out, len(payload), None, ((0xC7, 1), (0xC8, 2), (0xC9, 4)))
        out += struct.pack(">b", code)
        out += payload
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")
