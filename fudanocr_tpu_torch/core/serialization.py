"""The JAX package's checkpoint bytes (`flax.serialization.to_bytes` /
`from_bytes`, flax/serialization.py:249-460) with no flax or msgpack: a
msgpack encoder and decoder of its own for the subset flax writes.

A tree is nested string-keyed maps (flax's `to_state_dict` form: a
list, tuple or NamedTuple is already a map there). Leaves:

* an array (numpy, or a torch tensor, which is copied to the host) is
  msgpack ext type 1 whose payload is the msgpack array (shape, dtype
  name, C-order bytes); `bfloat16` travels by its name, its bits as
  uint16 (a torch bfloat16 tensor on the way out, and read back as one:
  numpy has no bfloat16);
* a numpy scalar is ext type 3, the same payload at shape () (a
  bfloat16 one reads as a `BFloat16Scalar`, a float);
* None, bool, int, float (float64) and str are msgpack's own.

An array larger than `MAX_CHUNK_SIZE` bytes is written as flax's chunked
map {"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}
of flat pieces and joined again on reading. Every value takes the
smallest encoding, as msgpack-python's packer picks it, and maps keep
their key order, so bytes read and written back are the same bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30          # flax/serialization.py:324
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


# -- encoding ---------------------------------------------------------------

def _host_array(x) -> Tuple[np.ndarray, str]:
    """(numpy array of x's bits, dtype name): bfloat16 as uint16."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), t.numpy().dtype.name
    return x, x.dtype.name


def _pack_len(out: List[bytes], n: int, fix: int, fixmax: int,
              codes: Tuple[int, int, int]) -> None:
    """A str / bin / array / map header: fix form below `fixmax` (fix < 0:
    none), else 8-, 16- or 32-bit length."""
    if fix >= 0 and n < fixmax:
        out.append(bytes((fix | n,)))
    elif codes[0] and n < 0x100:
        out.append(bytes((codes[0], n)))
    elif n < 0x10000:
        out.append(struct.pack(">BH", codes[1], n))
    else:
        out.append(struct.pack(">BI", codes[2], n))


def _pack_int(out: List[bytes], x: int) -> None:
    if 0 <= x < 0x80 or -0x20 <= x < 0:
        out.append(struct.pack(">b" if x < 0 else ">B", x))
    elif x >= 0:
        for code, fmt, top in ((0xcc, ">BB", 0x100), (0xcd, ">BH", 0x10000),
                               (0xce, ">BI", 1 << 32),
                               (0xcf, ">BQ", 1 << 64)):
            if x < top:
                out.append(struct.pack(fmt, code, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack")
    else:
        for code, fmt, low in ((0xd0, ">Bb", -0x80), (0xd1, ">Bh", -0x8000),
                               (0xd2, ">Bi", -(1 << 31)),
                               (0xd3, ">Bq", -(1 << 63))):
            if x >= low:
                out.append(struct.pack(fmt, code, x))
                return
        raise OverflowError(f"int {x} does not fit msgpack")


def _pack_bytes(out: List[bytes], b) -> None:
    _pack_len(out, len(b), -1, 0, (0xc4, 0xc5, 0xc6))
    out.append(b)


def _pack_str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(out, len(b), 0xa0, 32, (0xd9, 0xda, 0xdb))
    out.append(b)


def _ndarray_payload(arr: np.ndarray, name: str) -> bytes:
    """msgpack of (shape, dtype name, C-order bytes), flax's
    `_ndarray_to_bytes`."""
    out: List[bytes] = [b"\x93"]
    _pack_len(out, arr.ndim, 0x90, 16, (0, 0xdc, 0xdd))
    for d in arr.shape:
        _pack_int(out, int(d))
    _pack_str(out, name)
    _pack_bytes(out, arr.tobytes("C"))
    return b"".join(out)


def _pack_ext(out: List[bytes], code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(bytes((fixed[n], code)))
    elif n < 0x100:
        out.append(bytes((0xc7, n, code)))
    elif n < 0x10000:
        out.append(struct.pack(">BHB", 0xc8, n, code))
    else:
        out.append(struct.pack(">BIB", 0xc9, n, code))
    out.append(data)


def _chunked(x, shape, itemsize: int) -> Dict[str, Any]:
    """flax's `_chunk`: array `x` flat, in pieces of MAX_CHUNK_SIZE bytes
    (each piece an array leaf of x's kind and dtype)."""
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(shape)},
            "chunks": {str(j): flat[s:s + size] for j, s in
                       enumerate(range(0, flat.shape[0], size))}}


class BFloat16Scalar(float):
    """A bfloat16 numpy scalar (ext type 3) read back: its value, which a
    float holds exactly; written back as the same scalar."""


def _pack(out: List[bytes], x: Any) -> None:
    if isinstance(x, (torch.Tensor, np.ndarray)):
        arr, name = _host_array(x)
        if arr.size * arr.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunked(x, arr.shape, arr.dtype.itemsize))
        else:
            _pack_ext(out, _EXT_NDARRAY, _ndarray_payload(arr, name))
    elif isinstance(x, BFloat16Scalar):
        bits = np.array(np.float32(x).view(np.uint32) >> 16, np.uint16)
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(bits, "bfloat16"))
    elif isinstance(x, np.generic):
        arr = np.asarray(x)
        _pack_ext(out, _EXT_NPSCALAR, _ndarray_payload(arr, arr.dtype.name))
    elif isinstance(x, dict):
        _pack_len(out, len(x), 0x80, 16, (0, 0xde, 0xdf))
        for k, v in x.items():
            _pack_str(out, str(k))
            _pack(out, v)
    elif x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(struct.pack(">Bd", 0xcb, x))
    elif isinstance(x, str):
        _pack_str(out, x)
    else:
        raise TypeError(f"cannot serialize a {type(x).__name__}")


def to_bytes(tree: Any) -> bytes:
    """`tree` (nested dicts of arrays, tensors and scalars, the state-dict
    form `flax.serialization.to_state_dict` gives) as the bytes
    `flax.serialization.to_bytes` gives for its JAX counterpart."""
    out: List[bytes] = []
    _pack(out, tree)
    return b"".join(out)


# -- decoding ---------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        v = self.buf[self.pos:self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED_EXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_SIZED = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I",        # bin
          0xd9: ">B", 0xda: ">H", 0xdb: ">I",        # str
          0xdc: ">H", 0xdd: ">I",                    # array
          0xde: ">H", 0xdf: ">I",                    # map
          0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}        # ext
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _read(r: _Reader, raw: bool = False) -> Any:
    b = r.take(1)[0]
    if b < 0x80:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f, raw)
    if 0x90 <= b <= 0x9f:
        return [_read(r, raw) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        s = bytes(r.take(b & 0x1f))
        return s if raw else s.decode("utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _NUMBERS:
        return r.unpack(_NUMBERS[b])
    if b in _FIXED_EXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXED_EXT[b]))
    if b in _SIZED:
        n = r.unpack(_SIZED[b])
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(r.take(n))
        if b in (0xc7, 0xc8, 0xc9):
            code = r.unpack(">b")
            return _ext(code, r.take(n))
        if b in (0xd9, 0xda, 0xdb):
            s = bytes(r.take(n))
            return s if raw else s.decode("utf-8")
        if b in (0xdc, 0xdd):
            return [_read(r, raw) for _ in range(n)]
        return _read_map(r, n, raw)
    raise ValueError(f"msgpack byte 0x{b:02x} is not supported")


def _read_map(r: _Reader, n: int, raw: bool) -> Dict:
    out = {}
    for _ in range(n):
        k = _read(r, raw)
        out[k] = _read(r, raw)
    return out


def _array_from_payload(data) -> Any:
    r = _Reader(data)
    shape, name, buf = _read(r, raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data) -> Any:
    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        a = _array_from_payload(data)
        return BFloat16Scalar(a) if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack ext type {code} is not supported")


def _unchunk(d: Dict) -> Any:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(x: Any) -> Any:
    if isinstance(x, dict):
        if _CHUNKED in x:
            return _unchunk(x)
        for k, v in x.items():
            x[k] = _unchunk_tree(v)
    return x


def from_bytes(data) -> Any:
    """The tree of bytes written by `flax.serialization.to_bytes` (or
    `to_bytes`): nested dicts of numpy arrays (bfloat16 ones as torch
    bfloat16 tensors), numpy scalars and Python values."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         "object")
    return _unchunk_tree(tree)
