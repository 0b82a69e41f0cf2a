"""GGUF container reader/writer (reference: ggml/include/gguf.h,
ggml/src/gguf.cpp — GGUF v3).

whisper's own loader uses the legacy raw format (formats/container.py), but
the surrounding ggml ecosystem stores models as GGUF; this module reads and
writes it so checkpoints can round-trip with llama.cpp-family tooling.

Layout (little-endian):
  magic "GGUF" | version u32 | n_tensors i64 | n_kv i64
  n_kv x { key: string, type u32, value }       string = u64 len + bytes
  n_tensors x { name: string, n_dims u32, dims u64[n], ggml_type u32,
                offset u64 }                    offset within the data blob
  padding to `general.alignment` (default 32), then the tensor data blob
  with each tensor aligned likewise.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import quants

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

# enum gguf_type (gguf.h:53-68)
T_UINT8, T_INT8, T_UINT16, T_INT16 = 0, 1, 2, 3
T_UINT32, T_INT32, T_FLOAT32, T_BOOL = 4, 5, 6, 7
T_STRING, T_ARRAY, T_UINT64, T_INT64, T_FLOAT64 = 8, 9, 10, 11, 12

_SCALAR_FMT = {
    T_UINT8: "<B", T_INT8: "<b", T_UINT16: "<H", T_INT16: "<h",
    T_UINT32: "<I", T_INT32: "<i", T_FLOAT32: "<f", T_BOOL: "<?",
    T_UINT64: "<Q", T_INT64: "<q", T_FLOAT64: "<d",
}


def _guess_type(v: Any) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_INT64 if (v < -(2 ** 31) or v >= 2 ** 32) else (
            T_UINT32 if v >= 0 else T_INT32)
    if isinstance(v, float):
        return T_FLOAT32
    if isinstance(v, (str, bytes)):
        return T_STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return T_ARRAY
    raise TypeError(f"cannot map {type(v)} to a gguf type")


@dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]   # numpy (row-major) order; on disk reversed
    ggml_type: int
    offset: int
    data: Optional[bytes] = None

    @property
    def n_elems(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def nbytes(self) -> int:
        return quants.row_size(self.ggml_type, self.n_elems)

    def to_f32(self) -> np.ndarray:
        assert self.data is not None
        return quants.dequantize(self.data, self.ggml_type,
                                 self.n_elems).reshape(self.shape)


@dataclass
class GGUFFile:
    kv: Dict[str, Any] = field(default_factory=dict)
    tensors: List[GGUFTensorInfo] = field(default_factory=list)
    alignment: int = GGUF_DEFAULT_ALIGNMENT

    def tensor(self, name: str) -> GGUFTensorInfo:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------

def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, t: int):
    if t in _SCALAR_FMT:
        fmt = _SCALAR_FMT[t]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]
    if t == T_STRING:
        return _read_str(f)
    if t == T_ARRAY:
        (at,) = struct.unpack("<I", f.read(4))
        (n,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, at) for _ in range(n)]
    raise ValueError(f"bad gguf type {t}")


def read_gguf(path: str, load_data: bool = True) -> GGUFFile:
    with open(path, "rb") as f:
        if f.read(4) != GGUF_MAGIC:
            raise ValueError("not a GGUF file (bad magic)")
        (version,) = struct.unpack("<I", f.read(4))
        # v2 files have the identical little-endian layout (v3 only added
        # big-endian support) and are accepted by the reference reader
        # (ggml/src/gguf.cpp), so accept both; reject v1 and unknown futures.
        if version not in (2, GGUF_VERSION):
            raise ValueError(f"unsupported GGUF version {version}")
        n_tensors, n_kv = struct.unpack("<qq", f.read(16))

        out = GGUFFile()
        for _ in range(n_kv):
            key = _read_str(f)
            (t,) = struct.unpack("<I", f.read(4))
            out.kv[key] = _read_value(f, t)
        out.alignment = int(out.kv.get("general.alignment",
                                       GGUF_DEFAULT_ALIGNMENT))

        for _ in range(n_tensors):
            name = _read_str(f)
            (n_dims,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
            t, off = struct.unpack("<IQ", f.read(12))
            out.tensors.append(GGUFTensorInfo(
                name, tuple(reversed([int(d) for d in dims])), t, off))

        # data section starts at the next alignment boundary
        pos = f.tell()
        data_start = pos + (-pos) % out.alignment
        if load_data:
            for ti in out.tensors:
                f.seek(data_start + ti.offset)
                ti.data = f.read(ti.nbytes)
        return out


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------

def _write_str(f: BinaryIO, s: Union[str, bytes]) -> None:
    b = s.encode("utf-8") if isinstance(s, str) else s
    f.write(struct.pack("<Q", len(b)))
    f.write(b)


def _write_value(f: BinaryIO, v: Any, t: Optional[int] = None) -> int:
    t = _guess_type(v) if t is None else t
    f.write(struct.pack("<I", t))
    _write_value_raw(f, v, t)
    return t


def _write_value_raw(f: BinaryIO, v: Any, t: int) -> None:
    if t in _SCALAR_FMT:
        f.write(struct.pack(_SCALAR_FMT[t], v))
    elif t == T_STRING:
        _write_str(f, v)
    elif t == T_ARRAY:
        items = list(v)
        at = _guess_type(items[0]) if items else T_INT32
        f.write(struct.pack("<I", at))
        f.write(struct.pack("<Q", len(items)))
        for item in items:
            _write_value_raw(f, item, at)
    else:
        raise ValueError(f"bad gguf type {t}")


def write_gguf(path: str, kv: Dict[str, Any],
               tensors: Sequence[Tuple[str, np.ndarray, int]],
               alignment: int = GGUF_DEFAULT_ALIGNMENT) -> None:
    """tensors: (name, array, ggml_type); arrays quantize via
    formats.quants like the legacy writer."""
    packed: List[Tuple[str, Tuple[int, ...], int, bytes]] = []
    for name, arr, t in tensors:
        arr = np.asarray(arr)
        raw = quants.quantize(arr.astype(np.float32), t)
        packed.append((name, arr.shape, t, raw))

    if alignment != GGUF_DEFAULT_ALIGNMENT:
        # readers (ours and the reference's) assume 32 unless the file says
        # otherwise — record non-default alignments in the kv section
        kv = dict(kv)
        kv["general.alignment"] = int(alignment)

    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", GGUF_VERSION))
        f.write(struct.pack("<qq", len(packed), len(kv)))
        for k, v in kv.items():
            _write_str(f, k)
            _write_value(f, v)

        offset = 0
        for name, shape, t, raw in packed:
            _write_str(f, name)
            dims = list(reversed(shape))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", t, offset))
            offset += len(raw) + (-len(raw)) % alignment

        pos = f.tell()
        f.write(b"\x00" * ((-pos) % alignment))
        for _, _, _, raw in packed:
            f.write(raw)
            f.write(b"\x00" * ((-len(raw)) % alignment))
