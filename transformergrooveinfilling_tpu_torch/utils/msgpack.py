"""msgpack as flax writes and reads it, on the standard library and numpy
(the machine with the card has neither flax nor the ``msgpack`` package).

:func:`serialize` gives the bytes ``flax.serialization.msgpack_serialize``
gives for the same tree: flax copies the tree through ``jax.tree_util`` first,
which sorts every dict's keys, so :func:`serialize` writes keys sorted too; an array
leaf larger than :data:`MAX_CHUNK_SIZE` bytes (a dict value or the root) goes
out in flax's chunked form; then msgpack with ``strict_types``. Types:

- nil, bool, int (64-bit), ``float`` (float64), ``str``, ``bytes`` (bin),
  ``list`` / ``tuple`` (array), ``dict`` (map);
- numpy arrays as ext type 1, ``packb((shape, dtype name, C-order bytes))``;
  a CPU ``torch.Tensor`` likewise (bfloat16 as its 16-bit words, named
  ``"bfloat16"``, as a JAX bf16 array is written);
- numpy scalars (``np.float32(1)``, also ``np.float64``) as ext type 3, the
  same payload at shape ``()``;
- ``complex`` as ext type 2, ``packb((real, imag))``.

:func:`restore` reads all of msgpack and those ext types back: arrays as
read-only numpy views of the input (copy them to write), ``"bfloat16"``
arrays as ``torch.bfloat16`` tensors (numpy has no such type), type 3 as
numpy scalars; chunked arrays are joined again. Any other ext type raises
``ValueError``.
"""

from __future__ import annotations

import struct

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


# ------------------------------------------------------------------ writing


def _torch():
    import torch

    return torch


def _is_tensor(obj) -> bool:
    return type(obj).__module__.startswith("torch") and hasattr(obj, "element_size")


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if _is_tensor(arr) else arr.size * arr.dtype.itemsize


def _chunk(arr) -> dict:
    """flax's ``_chunk``: a flat array in pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = arr.element_size() if _is_tensor(arr) else arr.dtype.itemsize
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = arr.reshape(-1)
    size = flat.numel() if _is_tensor(arr) else flat.size
    pieces = [flat[i:i + step] for i in range(0, size, step)]
    return {_CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def _is_array(obj) -> bool:
    return isinstance(obj, np.ndarray) or _is_tensor(obj)


def _prepare(obj, chunk: bool = True):
    """flax's copy of the tree: dict keys sorted, big array leaves chunked."""
    if type(obj) is dict:
        return {k: _prepare(obj[k], chunk) for k in sorted(obj)}
    if type(obj) in (list, tuple):
        return type(obj)(_prepare(v, chunk=False) for v in obj)
    if chunk and _is_array(obj) and _nbytes(obj) > MAX_CHUNK_SIZE:
        return _chunk(obj)
    return obj


def _array_payload(arr) -> bytes:
    if _is_tensor(arr):
        torch = _torch()
        t = arr.detach().contiguous()
        if t.device.type != "cpu":
            raise ValueError("packb takes CPU tensors; copy device tensors to the host first")
        if t.dtype == torch.bfloat16:
            return packb((tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()))
        arr = t.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {size: code for code, size in _FIXEXT.items()}
    if n in fixed:
        out.append(fixed[n])
    elif n < 1 << 8:
        out += bytes((0xC7, n))
    elif n < 1 << 16:
        out += struct.pack(">BH", 0xC8, n)
    elif n < 1 << 32:
        out += struct.pack(">BI", 0xC9, n)
    else:
        raise ValueError("ext data too large for msgpack")
    out += struct.pack(">b", code)
    out += data


def _pack_int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 1 << 7:
            out.append(v)
        elif v < 1 << 8:
            out += bytes((0xCC, v))
        elif v < 1 << 16:
            out += struct.pack(">BH", 0xCD, v)
        elif v < 1 << 32:
            out += struct.pack(">BI", 0xCE, v)
        elif v < 1 << 64:
            out += struct.pack(">BQ", 0xCF, v)
        else:
            raise OverflowError(f"int {v} does not fit 64 bits")
    elif v >= -(1 << 5):
        out += struct.pack(">b", v)
    elif v >= -(1 << 7):
        out += struct.pack(">Bb", 0xD0, v)
    elif v >= -(1 << 15):
        out += struct.pack(">Bh", 0xD1, v)
    elif v >= -(1 << 31):
        out += struct.pack(">Bi", 0xD2, v)
    elif v >= -(1 << 63):
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError(f"int {v} does not fit 64 bits")


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes`` (c8, c16, c32); c8 None where the type has no 8-bit form)."""
    c8, c16, c32 = codes
    if n < fix_max:
        out.append(fix | n)
    elif c8 is not None and n < 1 << 8:
        out += bytes((c8, n))
    elif n < 1 << 16:
        out += struct.pack(">BH", c16, n)
    elif n < 1 << 32:
        out += struct.pack(">BI", c32, n)
    else:
        raise ValueError("object too large for msgpack")


def _pack(out: bytearray, obj) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, obj)
    elif t is str:
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif t is bytes:
        data = obj
        if len(data) < 1 << 8:
            out += bytes((0xC4, len(data)))
        elif len(data) < 1 << 16:
            out += struct.pack(">BH", 0xC5, len(data))
        else:
            out += struct.pack(">BI", 0xC6, len(data))
        out += data
    elif t in (list, tuple):
        _pack_len(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _pack_len(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif _is_array(obj):
        _pack_ext(out, EXT_NDARRAY, _array_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(obj)))
    elif t is complex:
        _pack_ext(out, EXT_COMPLEX, packb((obj.real, obj.imag)))
    else:
        raise TypeError(f"cannot write {t.__name__!r} to msgpack")


def packb(obj) -> bytes:
    """msgpack bytes of ``obj``, without flax's tree preparation."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


def serialize(tree) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    return packb(_prepare(tree))


# ------------------------------------------------------------------ reading


_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
            0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# the length field of bin (C4-C6), ext (C7-C9), str (D9-DB), array (DC, DD), map (DE, DF)
_LENGTHS = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
            0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _LENGTHS:
            raise ValueError(f"0x{b:02x} is not a msgpack type byte")
        n = self.unpack(_LENGTHS[b])
        if b <= 0xC6:
            return bytes(self.take(n))
        if b <= 0xC9:
            return self.ext(n)
        if b <= 0xDB:
            return str(self.take(n), "utf-8")
        if b <= 0xDD:
            return [self.read() for _ in range(n)]
        return self.map(n)

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _array_from(data)
        if code == EXT_NPSCALAR:
            arr = _array_from(data)
            return arr if _is_tensor(arr) else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).read()
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _array_from(data):
    shape, name, buf = _Reader(data).read()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        torch = _torch()
        words = np.frombuffer(buf, dtype=np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(tuple(shape))
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(tuple(shape), order="C")


def _unchunk(d):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
            parts = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            if _is_tensor(parts[0]):
                return _torch().cat(parts).reshape(shape)
            return np.concatenate(parts).reshape(shape)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v)
    return d


def unpackb(data):
    """The tree in ``data`` (bytes-like), without flax's chunk joining."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("extra bytes after the msgpack object")
    return out


def restore(data):
    """``flax.serialization.msgpack_restore(data)``: the tree, chunked arrays
    joined."""
    return _unchunk(unpackb(data))
