"""A small pure-Python msgpack codec for the reference's checkpoint files.

``vts_tpu`` writes ``<tag>_net_<Name>.msgpack`` with
``flax.serialization.msgpack_serialize``: a msgpack map of nested maps whose
array leaves are ext type 1 with payload ``packb((shape, dtype_name,
C-order bytes))`` and whose numpy scalars are ext type 3 with the same
payload.  This module reads and writes that format with numpy only, so the
port needs neither ``msgpack`` nor ``flax``.  Arrays above flax's 1 GiB
chunking threshold are not supported (no checkpoint here comes near it).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


# ---------------------------------------------------------------- packing ---

def _pack_uint_len(n: int, fix_base: int, fix_max: int, codes: Tuple[int, ...],
                   out: bytearray) -> None:
    """Length header: fix form if n < fix_max, else 8/16/32-bit forms
    (``codes`` lists the markers, None where a width does not exist)."""
    if fix_max and n < fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, lim in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < lim:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too large ({n})")


def _pack(obj: Any, out: bytearray) -> None:
    # numpy first: np.float64 subclasses float, and flax packs it as ext 3
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes are not supported")
        payload = packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))
        code = _EXT_NDARRAY if isinstance(obj, np.ndarray) else _EXT_NPSCALAR
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(fixext[n])
        else:
            _pack_uint_len(n, 0, 0, (0xC7, 0xC8, 0xC9), out)
        out.append(code)
        out += payload
    elif obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj < 128:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                   (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
                if obj < lim:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    break
            else:
                raise ValueError("integer too large for msgpack")
        else:
            for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                   (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
                if obj >= -lim:
                    out.append(code)
                    out += struct.pack(fmt, obj)
                    break
            else:
                raise ValueError("integer too small for msgpack")
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_uint_len(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _pack_uint_len(len(obj), 0, 0, (0xC4, 0xC5, 0xC6), out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_uint_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_uint_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# -------------------------------------------------------------- unpacking ---

class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        v = self.data[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ext(code: int, payload: bytes):
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, buf = unpackb(payload, raw=True)
        name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
        if name == "bfloat16":
            raise TypeError("bfloat16 checkpoint leaves are not supported")
        arr = np.frombuffer(bytes(buf), dtype=np.dtype(name)).reshape(shape, order="C").copy()
        return arr[()] if code == _EXT_NPSCALAR else arr
    raise ValueError(f"unknown msgpack ext type {code}")


def _unpack(r: _Reader, raw: bool) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r, b & 0x1F, raw)
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
    if b in (0xC7, 0xC8, 0xC9):
        n = r.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
        n = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}[b]
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    nums = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in nums:
        return r.unpack(nums[b])
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r, r.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
    if b in (0xDC, 0xDD):
        return [_unpack(r, raw) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise ValueError(f"unsupported msgpack marker 0x{b:02x}")


def _str(r: _Reader, n: int, raw: bool):
    b = bytes(r.take(n))
    return b if raw else b.decode("utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        out[k] = _unpack(r, raw)
    return out


def unpackb(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data)
    obj = _unpack(r, raw)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after msgpack object")
    return obj


def msgpack_restore(data: bytes) -> Any:
    """Counterpart of ``flax.serialization.msgpack_restore``."""
    tree = unpackb(data)
    if isinstance(tree, dict) and "__msgpack_chunked_array__" in tree:
        raise ValueError("chunked (> 1 GiB) array leaves are not supported")
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """Counterpart of ``flax.serialization.msgpack_serialize`` for trees of
    dicts, lists and numpy arrays."""
    return packb(tree)
