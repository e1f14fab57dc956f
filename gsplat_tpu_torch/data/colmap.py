"""COLMAP sparse-model parsers (binary + text), numpy-only.

Behavioral spec: reference scene/colmap_loader.py:43-282.  A copy of
``gsplat_tpu/data/colmap.py`` (the port imports nothing of the JAX package):
``read_points3D_binary`` goes through the native C++ parser
(``data/native.py``) whenever the library loads, as the JAX module does, so
its xyz passes through float32 there.  Bulk struct parsing (single read + unpack_from sweeps) rather
than per-field ``read_next_bytes`` calls, same outputs.
"""
from __future__ import annotations

import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np


class CameraModelSpec(NamedTuple):
    model_id: int
    model_name: str
    num_params: int


CAMERA_MODELS = [
    CameraModelSpec(0, "SIMPLE_PINHOLE", 3),
    CameraModelSpec(1, "PINHOLE", 4),
    CameraModelSpec(2, "SIMPLE_RADIAL", 4),
    CameraModelSpec(3, "RADIAL", 5),
    CameraModelSpec(4, "OPENCV", 8),
    CameraModelSpec(5, "OPENCV_FISHEYE", 8),
    CameraModelSpec(6, "FULL_OPENCV", 12),
    CameraModelSpec(7, "FOV", 5),
    CameraModelSpec(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModelSpec(9, "RADIAL_FISHEYE", 5),
    CameraModelSpec(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3D_ids: np.ndarray


def qvec2rotmat(qvec):
    """colmap_loader.py:31-41."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R):
    """colmap_loader.py (inverse map), used by pose exporters."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz]]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# --- binary readers ---------------------------------------------------------

def read_intrinsics_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    for _ in range(n):
        cam_id, model_id, w, h = struct.unpack_from("<iiQQ", data, off)
        off += 24
        spec = CAMERA_MODEL_IDS[model_id]
        params = np.array(struct.unpack_from(f"<{spec.num_params}d", data, off))
        off += 8 * spec.num_params
        cams[cam_id] = ColmapCamera(cam_id, spec.model_name, int(w), int(h), params)
    return cams


def read_extrinsics_binary(path) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    for _ in range(n):
        img_id = struct.unpack_from("<i", data, off)[0]
        vals = struct.unpack_from("<7d", data, off + 4)
        cam_id = struct.unpack_from("<i", data, off + 60)[0]
        off += 64
        end = data.index(b"\x00", off)
        name = data[off:end].decode("utf-8")
        off = end + 1
        (npts,) = struct.unpack_from("<Q", data, off)
        off += 8
        rec = np.frombuffer(data, dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")]),
                            count=npts, offset=off)
        off += 24 * npts
        imgs[img_id] = ColmapImage(
            id=img_id, qvec=np.array(vals[:4]), tvec=np.array(vals[4:7]),
            camera_id=cam_id, name=name,
            xys=np.stack([rec["x"], rec["y"]], axis=1),
            point3D_ids=np.asarray(rec["id"]),
        )
    return imgs


def read_points3D_binary(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3], rgb [N,3] uint8-valued, error [N,1]).
    Uses the native C++ parser where it loads (native/gsplat_io.cpp)."""
    from gsplat_tpu_torch.data import native
    if native.available():
        out = native.read_points3d_binary(path)
        if out is not None:
            return out
    return read_points3D_binary_python(path)


def read_points3D_binary_python(path):
    """``read_points3D_binary``'s pure-python path (float64 throughout)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack_from("<Q", data, 0)
    off = 8
    xyz = np.empty((n, 3))
    rgb = np.empty((n, 3))
    err = np.empty((n, 1))
    head = np.dtype([("id", "<i8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                     ("err", "<f8"), ("tlen", "<Q")])
    for i in range(n):
        rec = np.frombuffer(data, dtype=head, count=1, offset=off)[0]
        off += head.itemsize
        xyz[i] = rec["xyz"]
        rgb[i] = rec["rgb"]
        err[i] = rec["err"]
        off += 8 * int(rec["tlen"])  # skip track (i32 image_id, i32 p2d_idx)
    return xyz, rgb, err


# --- text readers -----------------------------------------------------------

def read_intrinsics_text(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            cam_id = int(t[0])
            model = t[1]
            w, h = int(t[2]), int(t[3])
            params = np.array([float(x) for x in t[4:]])
            cams[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return cams


def read_extrinsics_text(path) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    # Each record is an image line followed unconditionally by one POINTS2D
    # line (which may be EMPTY for images without track observations).  Skip
    # blank/comment lines only when LOOKING FOR an image line — that way a
    # stray blank between records (which COLMAP's own parser tolerates)
    # cannot shift the pairing, while an empty POINTS2D line directly after
    # an image line is still consumed as that record's second line.
    i = 0
    while i < len(lines):
        if not lines[i] or lines[i].startswith("#"):
            i += 1
            continue
        t = lines[i].split()
        img_id = int(t[0])
        qvec = np.array([float(x) for x in t[1:5]])
        tvec = np.array([float(x) for x in t[5:8]])
        cam_id = int(t[8])
        name = t[9]
        e = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = (np.array([float(v) for v in e]).reshape(-1, 3)[:, :2]
               if e else np.zeros((0, 2)))
        ids = (np.array([int(float(v)) for v in e[2::3]])
               if e else np.zeros(0, np.int64))
        imgs[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name, xys, ids)
        i += 2
    return imgs


def read_points3D_text(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split()
            xyzs.append([float(x) for x in t[1:4]])
            rgbs.append([float(x) for x in t[4:7]])
            errs.append([float(t[7])])
    return np.array(xyzs), np.array(rgbs), np.array(errs)


# --- writers (for converters / tests) ---------------------------------------

def write_intrinsics_text(path, cams: Dict[int, ColmapCamera]):
    with open(path, "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            params = " ".join(repr(float(p)) for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")


def write_extrinsics_text(path, imgs: Dict[int, ColmapImage]):
    with open(path, "w") as f:
        f.write("# Image list\n")
        for im in imgs.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n\n")
