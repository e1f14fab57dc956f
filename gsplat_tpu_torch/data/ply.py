"""Minimal PLY reader (binary little/big-endian + ascii) and writer (binary
little-endian), numpy-only.

Port of ``gsplat_tpu/data/ply.py``: a binary little-endian file over 1 MiB
with no list property goes through the native C++ reader
(``data/native.py``) where it loads, exactly where the JAX module takes it,
and then every property comes back as float32 as it does there; the rest
is the pure-python path.  Reads and writes the vertex element of the
reference checkpoint schema
(x,y,z,nx,ny,nz,f_dc_*,f_rest_*,opacity,segment_*,scale_*,rot_*) and of
input point clouds (x,y,z,[nx,ny,nz],red,green,blue), byte for byte as the
JAX package writes them.
"""
from __future__ import annotations

import io
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int",
              "u4": "uint", "i1": "char", "i2": "short", "u2": "ushort"}


def _header_prop_names(path: str) -> Optional[List[str]]:
    """The vertex property names of a binary little-endian header, or None
    (another format, a list property, no properties)."""
    names = []
    with open(path, "rb") as f:
        head = f.read(65536)
    if b"end_header" not in head or b"binary_little_endian" not in head:
        return None
    in_vertex = False
    for line in head.split(b"\n"):
        t = line.strip().split()
        if not t:
            continue
        if t[0] == b"element":
            in_vertex = t[1] == b"vertex"
        elif t[0] == b"property" and in_vertex:
            if t[1] == b"list":
                return None
            names.append(t[-1].decode())
        elif t[0] == b"end_header":
            break
    return names or None


def _read_ply_native(path: str) -> Optional[Dict[str, np.ndarray]]:
    from gsplat_tpu_torch.data import native

    if not native.available():
        return None
    names = _header_prop_names(path)
    if not names:
        return None
    mat = native.ply_read_props(path, names)
    if mat is None:
        return None
    return {n: np.ascontiguousarray(mat[:, i]) for i, n in enumerate(names)}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element into a dict of 1-D property arrays.

    Large binary files go through the native C++ parser where it loads
    (every property float32 then); pure-python otherwise."""
    if os.path.getsize(path) > (1 << 20):
        out = _read_ply_native(path)
        if out is not None:
            return out
    return read_ply_python(path)


def read_ply_python(path: str) -> Dict[str, np.ndarray]:
    """``read_ply``'s pure-python path: each property in the file's type."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header = data[:header_end].decode("ascii", "replace").splitlines()
    body = data[header_end + len(b"end_header\n"):]

    fmt = None
    elements: List[Tuple[str, int, List[Tuple[str, str]]]] = []
    cur = None
    for line in header:
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elements.append(cur)
        elif t[0] == "property" and cur is not None:
            if t[1] == "list":
                cur[2].append((t[-1], f"LIST:{t[2]}:{t[3]}"))
            else:
                cur[2].append((t[-1], _PLY_TO_NP[t[1]]))

    out: Dict[str, np.ndarray] = {}
    offset = 0
    for name, count, props in elements:
        if any(p[1].startswith("LIST") for p in props):
            if name == "vertex":
                raise ValueError("list properties unsupported on vertex element")
            break  # faces etc. after vertex are not needed
        if fmt == "ascii":
            text = body.decode("ascii")
            rows = np.loadtxt(io.StringIO(text), max_rows=count, ndmin=2)
            for i, (pname, _) in enumerate(props):
                if name == "vertex":
                    out[pname] = rows[:, i]
            break
        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(p, endian + d) for p, d in props])
        arr = np.frombuffer(body, dtype=dtype, count=count, offset=offset)
        offset += dtype.itemsize * count
        if name == "vertex":
            for pname, _ in props:
                out[pname] = np.ascontiguousarray(arr[pname])
    return out


def _ply_type(dt: np.dtype) -> str:
    key = dt.str.lstrip("<>|=")
    if key not in _NP_TO_PLY:
        raise ValueError(f"unsupported dtype {dt}")
    return key


def write_ply(path: str, props: Dict[str, np.ndarray], comment: str = ""):
    """Write a binary little-endian PLY with one 'vertex' element.
    ``props`` is an ordered dict of 1-D arrays of equal length."""
    names = list(props.keys())
    n = len(next(iter(props.values())))
    cols = []
    for k in names:
        a = np.asarray(props[k])
        if a.ndim != 1 or len(a) != n:
            raise ValueError(f"property {k} bad shape {a.shape}")
        cols.append(a)
    dtype = np.dtype([(k, "<" + _ply_type(c.dtype))
                      for k, c in zip(names, cols)])
    rec = np.empty(n, dtype=dtype)
    for k, c in zip(names, cols):
        rec[k] = c
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        if comment:
            f.write(f"comment {comment}\n".encode())
        f.write(f"element vertex {n}\n".encode())
        for k, c in zip(names, cols):
            f.write(f"property {_NP_TO_PLY[_ply_type(c.dtype)]} {k}\n"
                    .encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())
