r"""
Reader and writer of the flax msgpack format, the format of the JAX package's
``.ckpt`` files (``probnmn_tpu/utils/checkpointing.py`` writes them through
``flax.serialization.msgpack_serialize``). Pure Python over ``struct``: the
port depends neither on flax nor on the ``msgpack`` package.

What a file holds:

- msgpack maps (string keys), arrays, strings, bin, ints, floats, bool and nil;
- ext type 1, an array: the msgpack triple ``(shape, dtype name, C-order
  bytes)``. ``bfloat16``, which numpy lacks, is read into a ``torch.bfloat16``
  tensor through an int16 view; every other dtype into a numpy array;
- ext type 3, a numpy scalar: the same triple of a 0-d array, read back as
  the numpy scalar (a 0-d ``torch.bfloat16`` tensor for ``bfloat16``);
- ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
  ...}}`` maps, which flax writes for an array over :data:`MAX_CHUNK_SIZE`
  bytes; they are read back as the whole array.

:func:`packb` writes what ``msgpack_serialize`` writes for the same tree,
byte for byte: maps with their keys sorted, the smallest encoding of every
int, floats as float64, lists and tuples as arrays, arrays (numpy or torch)
as ext 1 and numpy scalars as ext 3. Anything else, in either direction, raises ``ValueError`` (the byte
offset and type byte of what could not be read).
"""
from __future__ import annotations

import struct
from typing import Any, List, Tuple

import numpy as np
import torch

ARRAY_EXT = 1
SCALAR_EXT = 3
CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: arrays above this many bytes are chunked.
MAX_CHUNK_SIZE = 2 ** 30


# ------------------------------------------------------------------ reading ----------
class _Reader:
    def __init__(self, data, bins_as_views: bool = False):
        self.view = memoryview(data)
        self.pos = 0
        # An array's bytes are read in place (one copy, into the array).
        self.bins_as_views = bins_as_views

    def _take(self, n: int, start: int) -> memoryview:
        if self.pos + n > len(self.view):
            raise ValueError(f"msgpack: truncated at byte {start}: {n} bytes wanted, "
                             f"{len(self.view) - self.pos} left")
        out = self.view[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str, start: int):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt), start))[0]

    def read(self) -> Any:
        start = self.pos
        t = self._take(1, start)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self._map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self._array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self._str(t & 0x1F, start)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in _SIZED:
            kind, fmt = _SIZED[t]
            n = self._unpack(fmt, start)
            if kind == "bin":
                data = self._take(n, start)
                return data if self.bins_as_views else bytes(data)
            if kind == "str":
                return self._str(n, start)
            if kind == "array":
                return self._array(n)
            if kind == "map":
                return self._map(n)
            code = self._unpack(">b", start)
            return self._ext(code, n, start, t)
        if t in _NUMBERS:
            return self._unpack(_NUMBERS[t], start)
        if t in _FIXEXT:
            code = self._unpack(">b", start)
            return self._ext(code, _FIXEXT[t], start, t)
        raise ValueError(f"msgpack: type byte 0x{t:02x} at byte {start} is not part of the "
                         "flax checkpoint format")

    def _str(self, n: int, start: int) -> str:
        return str(self._take(n, start), "utf-8")

    def _array(self, n: int) -> List[Any]:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> Any:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        if out.get(CHUNKED) is True:
            return _unchunk(out)
        return out

    def _ext(self, code: int, n: int, start: int, t: int) -> Any:
        if code not in (ARRAY_EXT, SCALAR_EXT):
            raise ValueError(f"msgpack: ext type {code} (type byte 0x{t:02x}) at byte {start} "
                             "is not part of the flax checkpoint format")
        inner = _Reader(self._take(n, start), bins_as_views=True)
        triple = inner.read()
        if (inner.pos != n or not isinstance(triple, list) or len(triple) != 3
                or not isinstance(triple[0], list) or not isinstance(triple[2], memoryview)):
            raise ValueError(f"msgpack: ext type {code} at byte {start} does not hold "
                             "(shape, dtype, bytes)")
        shape, name, buffer = triple
        name = name.decode() if isinstance(name, bytes) else name
        array = _array_from_bytes(tuple(shape), name, buffer, start)
        if code == SCALAR_EXT:
            return array.reshape(()) if isinstance(array, torch.Tensor) else array[()]
        return array


_SIZED = {
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_NUMBERS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _array_from_bytes(shape: Tuple[int, ...], name: str, buffer: bytes, start: int):
    if name == "bfloat16":
        flat = np.frombuffer(buffer, dtype=np.int16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: array of dtype {name!r} at byte {start}") from None
    if dtype.hasobject:
        raise ValueError(f"msgpack: array of dtype {name!r} at byte {start}")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _unchunk(data: dict) -> Any:
    shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def unpackb(data: bytes) -> Any:
    r"""The tree a flax msgpack blob holds (``flax.serialization.msgpack_restore``)."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.view):
        raise ValueError(f"msgpack: {len(reader.view) - reader.pos} bytes after the value "
                         f"that ends at byte {reader.pos}")
    return out


# ------------------------------------------------------------------ writing ----------
def _array_bytes(x) -> bytes:
    r"""The ext payload of an array: the msgpack triple (shape, dtype name, bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _triple(x.shape, "bfloat16", x.view(torch.int16).numpy().tobytes())
        x = x.numpy()
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError(f"msgpack: cannot write an array of dtype {x.dtype}")
    return _triple(x.shape, x.dtype.name, x.tobytes("C"))


def _triple(shape, name: str, buffer: bytes) -> bytes:
    out: List[bytes] = []
    _pack([list(shape), name, buffer], out)
    return b"".join(out)


def _pack_ext(code: int, payload: bytes, out: List[bytes]) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(struct.pack(">Bb", fix[n], code))
    elif n < 2 ** 8:
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < 2 ** 16:
        out.append(struct.pack(">BHb", 0xC8, n, code))
    else:
        out.append(struct.pack(">BIb", 0xC9, n, code))
    out.append(payload)


def _pack_int(x: int, out: List[bytes]) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack(">B", x))
    elif -32 <= x < 0:
        out.append(struct.pack(">b", x))
    elif x >= 0:
        for t, fmt, top in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16), (0xCE, ">I", 2 ** 32),
                            (0xCF, ">Q", 2 ** 64)):
            if x < top:
                out.append(struct.pack(">B", t) + struct.pack(fmt, x))
                return
        raise ValueError(f"msgpack: int {x} does not fit 64 bits")
    else:
        for t, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15), (0xD2, ">i", -2 ** 31),
                            (0xD3, ">q", -2 ** 63)):
            if x >= low:
                out.append(struct.pack(">B", t) + struct.pack(fmt, x))
                return
        raise ValueError(f"msgpack: int {x} does not fit 64 bits")


def _pack_sized(n: int, fix_base: int, fix_max: int, sized: Tuple[int, ...], out: List[bytes]):
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack(">B", fix_base | n))
    elif sized[0] is not None and n < 2 ** 8:
        out.append(struct.pack(">BB", sized[0], n))
    elif n < 2 ** 16:
        out.append(struct.pack(">BH", sized[1], n))
    else:
        out.append(struct.pack(">BI", sized[2], n))


def _pack(x: Any, out: List[bytes]) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(ARRAY_EXT, _array_bytes(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(SCALAR_EXT, _array_bytes(np.asarray(x)), out)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is str:
        data = x.encode("utf-8")
        _pack_sized(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif type(x) is bytes:
        _pack_sized(len(x), None, -1, (0xC4, 0xC5, 0xC6), out)
        out.append(x)
    elif type(x) in (list, tuple):
        _pack_sized(len(x), 0x90, 15, (None, 0xDC, 0xDD), out)
        for item in x:
            _pack(item, out)
    elif type(x) is dict:
        _pack_sized(len(x), 0x80, 15, (None, 0xDE, 0xDF), out)
        for key, value in x.items():
            _pack(key, out)
            _pack(value, out)
    else:
        raise ValueError(f"msgpack: cannot write a {type(x).__name__}")


def _chunk(x) -> dict:
    r"""flax's ``_chunk``: a flat array cut into pieces of MAX_CHUNK_SIZE bytes."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    pieces = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True, "shape": {str(i): d for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(pieces)}}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk_leaves(x: Any) -> Any:
    r"""flax's ``_chunk_array_leaves_in_place`` (without the in place): arrays
    over MAX_CHUNK_SIZE bytes, at the top or inside maps, become chunk maps."""
    if isinstance(x, dict):
        return {k: _chunk_leaves(v) for k, v in x.items()}
    if isinstance(x, (np.ndarray, torch.Tensor)) and _nbytes(x) > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def _sorted_maps(x: Any) -> Any:
    r"""``msgpack_serialize`` copies its tree with ``jax.tree_util.tree_map``,
    which rebuilds every map with its keys sorted."""
    if isinstance(x, dict):
        return {k: _sorted_maps(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return type(x)(_sorted_maps(v) for v in x)
    return x


def packb(tree: Any) -> bytes:
    r"""``flax.serialization.msgpack_serialize(tree)``, byte for byte."""
    out: List[bytes] = []
    _pack(_chunk_leaves(_sorted_maps(tree)), out)
    return b"".join(out)
