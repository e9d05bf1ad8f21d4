"""The msgpack subset of a bundle's ``params.msgpack``, without the msgpack
package (the card machine has none).

flax (``flax.serialization.to_bytes``) writes a param tree as nested maps
with str keys whose leaves are ndarrays, each an ext value of type 1
holding a msgpack array ``(shape, dtype name, C-order bytes)``; bfloat16
goes by its name. ``unpackb`` reads that into nested dicts of CPU tensors
(any dtype below, bfloat16 included); ``packb`` writes it back from
tensors or numpy arrays, choosing the same encodings msgpack-python does,
so a tree encodes to the bytes flax writes for it. Anything else (nil,
booleans, floats, other ext types, non-str map keys, other dtypes) is
refused with ``ValueError``.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

NDARRAY_EXT = 1

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ----------------------------------------------------------------- decode
def unpackb(data: bytes) -> Any:
    """Decode one msgpack value that fills ``data``."""
    value, pos = _read(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after the value")
    return value


def _take(buf: memoryview, pos: int, n: int) -> tuple[bytes, int]:
    if pos + n > len(buf):
        raise ValueError("truncated msgpack data")
    return bytes(buf[pos: pos + n]), pos + n


def _uint(buf: memoryview, pos: int, size: int) -> tuple[int, int]:
    raw, pos = _take(buf, pos, size)
    return int.from_bytes(raw, "big"), pos


def _read(buf: memoryview, pos: int) -> tuple[Any, int]:
    tag, pos = _uint(buf, pos, 1)
    if tag <= 0x7F:
        return tag, pos
    if tag >= 0xE0:
        return tag - 0x100, pos
    if 0x80 <= tag <= 0x8F:
        return _read_map(buf, pos, tag & 0x0F)
    if 0x90 <= tag <= 0x9F:
        return _read_array(buf, pos, tag & 0x0F)
    if 0xA0 <= tag <= 0xBF:
        return _read_str(buf, pos, tag & 0x1F)
    if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        n, pos = _uint(buf, pos, 1 << (tag - 0xC4))
        return _take(buf, pos, n)
    if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n, pos = _uint(buf, pos, 1 << (tag - 0xC7))
        return _read_ext(buf, pos, n)
    if 0xD4 <= tag <= 0xD8:  # fixext 1/2/4/8/16
        return _read_ext(buf, pos, 1 << (tag - 0xD4))
    if 0xCC <= tag <= 0xCF:  # uint 8/16/32/64
        return _uint(buf, pos, 1 << (tag - 0xCC))
    if 0xD0 <= tag <= 0xD3:  # int 8/16/32/64
        raw, pos = _take(buf, pos, 1 << (tag - 0xD0))
        return int.from_bytes(raw, "big", signed=True), pos
    if tag in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        n, pos = _uint(buf, pos, 1 << (tag - 0xD9))
        return _read_str(buf, pos, n)
    if tag in (0xDC, 0xDD):  # array 16/32
        n, pos = _uint(buf, pos, 2 << (tag - 0xDC))
        return _read_array(buf, pos, n)
    if tag in (0xDE, 0xDF):  # map 16/32
        n, pos = _uint(buf, pos, 2 << (tag - 0xDE))
        return _read_map(buf, pos, n)
    raise ValueError(f"unsupported msgpack type byte 0x{tag:02x} at {pos - 1}")


def _read_str(buf: memoryview, pos: int, n: int) -> tuple[str, int]:
    raw, pos = _take(buf, pos, n)
    return raw.decode("utf-8"), pos


def _read_array(buf: memoryview, pos: int, n: int) -> tuple[list, int]:
    items = []
    for _ in range(n):
        item, pos = _read(buf, pos)
        items.append(item)
    return items, pos


def _read_map(buf: memoryview, pos: int, n: int) -> tuple[dict, int]:
    out: dict[str, Any] = {}
    for _ in range(n):
        key, pos = _read(buf, pos)
        if not isinstance(key, str):
            raise ValueError(f"map key {key!r} is not a string")
        out[key], pos = _read(buf, pos)
    return out, pos


def _read_ext(buf: memoryview, pos: int, n: int) -> tuple[torch.Tensor, int]:
    code, pos = _uint(buf, pos, 1)
    payload, pos = _take(buf, pos, n)
    if code != NDARRAY_EXT:
        raise ValueError(f"unsupported msgpack ext type {code}")
    fields = unpackb(payload)
    if not (isinstance(fields, list) and len(fields) == 3):
        raise ValueError("ndarray ext must hold (shape, dtype, bytes)")
    shape, name, raw = fields
    if isinstance(name, bytes):
        name = name.decode("ascii")
    if name not in _DTYPES or not isinstance(raw, bytes):
        raise ValueError(f"unsupported ndarray dtype {name!r}")
    dtype = _DTYPES[name]
    if not raw:
        return torch.empty(tuple(shape), dtype=dtype), pos
    flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(dtype)
    return flat.reshape(tuple(shape)), pos


# ----------------------------------------------------------------- encode
def packb(obj: Any) -> bytes:
    """Encode nested str-keyed dicts, lists/tuples, ints, str, bytes and
    array leaves (torch tensors or numpy arrays) as flax does."""
    out = bytearray()
    _write(out, obj)
    return bytes(out)


def _head(out: bytearray, n: int, fix: int | None, fix_max: int, tags: tuple) -> None:
    """A length header: the fix form when it fits, else the 8/16/32-bit
    form (tags for the widths without an 8-bit form are None)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= limit:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _write_int(out: bytearray, n: int) -> None:
    if 0 <= n <= 0x7F:
        out.append(n)
    elif -32 <= n < 0:
        out += struct.pack(">b", n)
    elif n > 0:
        for tag, fmt, limit in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if n <= limit:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too large for msgpack")
    else:
        for tag, fmt, limit in ((0xD0, ">b", 2**7), (0xD1, ">h", 2**15),
                                (0xD2, ">i", 2**31), (0xD3, ">q", 2**63)):
            if n >= -limit:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} too small for msgpack")


def _array_payload(leaf: torch.Tensor | np.ndarray) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise ValueError(f"unsupported tensor dtype {t.dtype}")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        return packb([list(t.shape), _NAMES[t.dtype], raw])
    a = np.asarray(leaf)
    if a.dtype.name not in _DTYPES:
        raise ValueError(f"unsupported array dtype {a.dtype}")
    return packb([list(a.shape), a.dtype.name, a.tobytes(order="C")])


def _write(out: bytearray, obj: Any) -> None:
    if isinstance(obj, dict):
        _head(out, len(obj), 0x80, 0x0F, (None, 0xDE, 0xDF))
        for key, value in obj.items():
            if not isinstance(key, str):
                raise ValueError(f"map key {key!r} is not a string")
            _write(out, key)
            _write(out, value)
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        payload = _array_payload(obj)
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + n.bit_length() - 1)
        else:
            _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
        out.append(NDARRAY_EXT)
        out += payload
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 0x1F, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, bytes):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 0x0F, (None, 0xDC, 0xDD))
        for item in obj:
            _write(out, item)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _write_int(out, obj)
    else:
        raise ValueError(f"cannot encode {type(obj).__name__} in a param tree")
