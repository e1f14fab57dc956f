"""ctypes bindings for the native IO core (PyTorch port of
``gsplat_tpu/data/native.py``, over the same ``native/gsplat_io.cpp``).

The committed ``native/libgsplat_io.so`` is loaded where it loads.  Where
it does not (missing, or built for another C library), the source is
compiled with ``g++ -O3 -std=c++17 -fPIC -shared`` into
``gsplat_tpu_torch/_build/`` and that library is loaded; nothing is ever
written into ``native/`` (the JAX module runs ``make -C native``).  Where
neither loads, ``available()`` is False and every caller takes its
pure-python path (``data/ply.py``, ``data/colmap.py``), as in the JAX
package: host I/O, no device.

``call_counts`` counts the calls that went through the library, so that a
run can show the native path is the one that ran.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import List, Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "gsplat_io.cpp")
_COMMITTED = os.path.join(os.path.dirname(_PKG_DIR), "native",
                          "libgsplat_io.so")
_BUILT = os.path.join(_PKG_DIR, "_build", "libgsplat_io.so")

_lib = None
_lib_path: Optional[str] = None
_tried = False

# successful calls into the library by entry point, since the last
# reset_call_counts()
call_counts = {"points3d": 0, "images": 0, "ply_read": 0, "ply_write": 0}


def reset_call_counts():
    for k in call_counts:
        call_counts[k] = 0


def _build() -> Optional[str]:
    """Compile ``native/gsplat_io.cpp`` into ``_build/``; the path, or None
    where there is no source or compiler."""
    if os.path.exists(_BUILT):
        return _BUILT
    if not os.path.exists(_SOURCE):
        return None
    os.makedirs(os.path.dirname(_BUILT), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_BUILT))
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared",
                        "-o", tmp, _SOURCE], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, _BUILT)      # whole, even with a concurrent build
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _BUILT


def _open() -> Optional[Tuple[ctypes.CDLL, str]]:
    if os.path.exists(_COMMITTED):
        try:
            return ctypes.CDLL(_COMMITTED), _COMMITTED
        except OSError:
            pass
    path = _build()
    if path is None:
        return None
    try:
        return ctypes.CDLL(path), path
    except OSError:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_path, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    opened = _open()
    if opened is None:
        return None
    lib, path = opened
    lib.colmap_points3d_read.restype = ctypes.c_int64
    lib.colmap_points3d_read.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.colmap_images_read.restype = ctypes.c_int64
    lib.colmap_images_read.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.ply_vertex_read.restype = ctypes.c_int64
    lib.ply_vertex_read.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_void_p]
    lib.ply_vertex_write.restype = ctypes.c_int64
    lib.ply_vertex_write.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_int64]
    _lib, _lib_path = lib, path
    return _lib


def available() -> bool:
    return _load() is not None


def library_path() -> Optional[str]:
    """The library that was loaded (the committed one or the build), or
    None."""
    _load()
    return _lib_path


def _names_buf(names: List[str]) -> bytes:
    return b"".join(n.encode() + b"\0" for n in names)


def read_points3d_binary(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                      np.ndarray]]:
    """(xyz [n,3], rgb [n,3], error [n,1]) as float64, or None; xyz and the
    error pass through the library's float32."""
    lib = _load()
    if lib is None:
        return None
    n = lib.colmap_points3d_read(path.encode(), None, None, None)
    if n < 0:
        return None
    xyz = np.empty((n, 3), np.float32)
    rgb = np.empty((n, 3), np.uint8)
    err = np.empty((n,), np.float32)
    r = lib.colmap_points3d_read(
        path.encode(), xyz.ctypes.data_as(ctypes.c_void_p),
        rgb.ctypes.data_as(ctypes.c_void_p),
        err.ctypes.data_as(ctypes.c_void_p))
    if r != n:
        return None
    call_counts["points3d"] += 1
    return (xyz.astype(np.float64), rgb.astype(np.float64),
            err[:, None].astype(np.float64))


def read_images_binary_meta(path: str):
    """-> (ids, qvec [n,4], tvec [n,3], camera_ids, names) or None."""
    lib = _load()
    if lib is None:
        return None
    nb = ctypes.c_int64(0)
    n = lib.colmap_images_read(path.encode(), None, None, None, None, None,
                               ctypes.byref(nb))
    if n < 0:
        return None
    ids = np.empty(n, np.int32)
    qvec = np.empty((n, 4), np.float64)
    tvec = np.empty((n, 3), np.float64)
    cams = np.empty(n, np.int32)
    names = ctypes.create_string_buffer(nb.value)
    r = lib.colmap_images_read(
        path.encode(), ids.ctypes.data_as(ctypes.c_void_p),
        qvec.ctypes.data_as(ctypes.c_void_p),
        tvec.ctypes.data_as(ctypes.c_void_p),
        cams.ctypes.data_as(ctypes.c_void_p), names, ctypes.byref(nb))
    if r != n:
        return None
    call_counts["images"] += 1
    name_list = bytes(names.raw).split(b"\0")[:n]
    return ids, qvec, tvec, cams, [s.decode() for s in name_list]


def ply_read_props(path: str, names: List[str]) -> Optional[np.ndarray]:
    """Read named vertex properties -> [n, len(names)] float32, or None."""
    lib = _load()
    if lib is None:
        return None
    n = lib.ply_vertex_read(path.encode(), _names_buf(names), len(names), None)
    if n < 0:
        return None
    out = np.empty((n, len(names)), np.float32)
    r = lib.ply_vertex_read(path.encode(), _names_buf(names), len(names),
                            out.ctypes.data_as(ctypes.c_void_p))
    if r != n:
        return None
    call_counts["ply_read"] += 1
    return out


def ply_write_props(path: str, names: List[str], data: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    data = np.ascontiguousarray(data, np.float32)
    r = lib.ply_vertex_write(path.encode(), _names_buf(names), len(names),
                             data.ctypes.data_as(ctypes.c_void_p),
                             data.shape[0])
    if r == data.shape[0]:
        call_counts["ply_write"] += 1
    return r == data.shape[0]
