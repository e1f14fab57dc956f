"""Scene/dataset readers: COLMAP, Blender (transforms_train.json), NeRFstudio
(transforms.json).

Behavioral spec: reference scene/dataset_readers.py:45-453 — including the
train/test llffhold split (idx % 8 == 0 -> test), nerf++ normalization radius,
NeRF->COLMAP axis flip (``matrix[:, 1:3] *= -1``), white-background alpha
compositing for Blender scenes, sibling ``depth/`` and ``segment/`` folder
lookup, the >7.5M point random subsample, and the random point-cloud inits.
A copy of ``gsplat_tpu/data/readers.py``: the port imports nothing of the
JAX package.  Images are opened with PIL, as there.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core.cameras import focal2fov, fov2focal, get_world2view2
from gsplat_tpu_torch.data import colmap as colmap_lib
from gsplat_tpu_torch.data import ply as ply_io


class CameraInfo(NamedTuple):
    uid: int
    R: np.ndarray
    T: np.ndarray
    FovY: float
    FovX: float
    image_path: str
    image_name: str
    width: int
    height: int
    depth_path: Optional[str] = None
    seg_path: Optional[str] = None
    white_background: bool = False


class BasicPointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


class SceneInfo(NamedTuple):
    point_cloud: Optional[BasicPointCloud]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


MAX_INIT_POINTS = 1_500_000 * 5  # dataset_readers.py:164-169


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    """Camera-extent normalization (dataset_readers.py:48-69)."""
    centers = []
    for cam in cam_infos:
        W2C = get_world2view2(cam.R, cam.T)
        C2W = np.linalg.inv(W2C)
        centers.append(C2W[:3, 3:4])
    centers = np.hstack(centers)
    avg = np.mean(centers, axis=1, keepdims=True)
    diagonal = float(np.max(np.linalg.norm(centers - avg, axis=0)))
    return {"translate": -avg.flatten(), "radius": diagonal * 1.1}


def _sibling_path(image_path: str, folder: str) -> Optional[str]:
    """depth/segment lookup by images->folder and jpg->png substitution
    (dataset_readers.py:109-140)."""
    p = image_path.replace(f"{os.sep}images{os.sep}", f"{os.sep}{folder}{os.sep}")
    if p == image_path:
        p = image_path.replace("images", folder, 1)
    for src, dst in ((".JPG", ".png"), (".jpg", ".png"), (".jpeg", ".png")):
        if p.endswith(src):
            p = p[: -len(src)] + dst
            break
    return p if os.path.exists(p) else None


def fetch_ply(path: str, rng: Optional[np.random.Generator] = None) -> BasicPointCloud:
    d = ply_io.read_ply(path)
    positions = np.stack([d["x"], d["y"], d["z"]], axis=1).astype(np.float32)
    if "red" in d:
        colors = np.stack([d["red"], d["green"], d["blue"]], axis=1) / 255.0
        normals = (np.stack([d["nx"], d["ny"], d["nz"]], axis=1)
                   if "nx" in d else np.zeros_like(positions))
    else:
        rng = rng or np.random.default_rng()
        colors = sh_lib.sh_to_rgb_dc(rng.random((len(positions), 3)) / 255.0)
        normals = np.zeros_like(positions)
    if len(positions) > MAX_INIT_POINTS:
        rng = rng or np.random.default_rng()
        sub = rng.choice(len(positions), MAX_INIT_POINTS, replace=False)
        positions, colors, normals = positions[sub], colors[sub], normals[sub]
    return BasicPointCloud(points=positions, colors=np.asarray(colors, np.float32),
                           normals=np.asarray(normals, np.float32))


def store_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """dataset_readers.py:179-196 schema."""
    n = len(xyz)
    props = {
        "x": xyz[:, 0].astype(np.float32), "y": xyz[:, 1].astype(np.float32),
        "z": xyz[:, 2].astype(np.float32),
        "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
        "red": rgb[:, 0].astype(np.uint8), "green": rgb[:, 1].astype(np.uint8),
        "blue": rgb[:, 2].astype(np.uint8),
    }
    ply_io.write_ply(path, props)


# --- COLMAP ------------------------------------------------------------------

def read_colmap_scene(path, images="images", eval_split=False, llffhold=8,
                      using_depth=False, using_seg=False) -> SceneInfo:
    """dataset_readers.py:196-241."""
    sparse = os.path.join(path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = colmap_lib.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        intr = colmap_lib.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = colmap_lib.read_extrinsics_text(os.path.join(sparse, "images.txt"))
        intr = colmap_lib.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    images_folder = os.path.join(path, images or "images")
    infos = []
    for key in extr:
        e = extr[key]
        c = intr[e.camera_id]
        R = np.transpose(colmap_lib.qvec2rotmat(e.qvec))
        T = np.array(e.tvec)
        if c.model == "SIMPLE_PINHOLE":
            FovY = focal2fov(c.params[0], c.height)
            FovX = focal2fov(c.params[0], c.width)
        elif c.model == "PINHOLE":
            FovY = focal2fov(c.params[1], c.height)
            FovX = focal2fov(c.params[0], c.width)
        else:
            raise ValueError(
                f"Colmap camera model {c.model} not handled: only undistorted "
                "datasets (PINHOLE or SIMPLE_PINHOLE) supported")
        image_path = os.path.join(images_folder, os.path.basename(e.name))
        image_name = os.path.basename(image_path).split(".")[0]
        infos.append(CameraInfo(
            uid=c.id, R=R, T=T, FovY=FovY, FovX=FovX,
            image_path=image_path, image_name=image_name,
            width=c.width, height=c.height,
            depth_path=_sibling_path(image_path, "depth") if using_depth else None,
            seg_path=_sibling_path(image_path, "segment") if using_seg else None,
        ))
    infos = sorted(infos, key=lambda x: x.image_name)

    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        bin_path = os.path.join(sparse, "points3D.bin")
        txt_path = os.path.join(sparse, "points3D.txt")
        if os.path.exists(bin_path):
            xyz, rgb, _ = colmap_lib.read_points3D_binary(bin_path)
        else:
            xyz, rgb, _ = colmap_lib.read_points3D_text(txt_path)
        store_ply(ply_path, xyz, rgb)
    try:
        pcd = fetch_ply(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(pcd, train, test, norm, ply_path)


# --- transforms.json family --------------------------------------------------

def _cams_from_transforms(path, transformsfile, white_background, extension="",
                          using_depth=False, using_seg=False,
                          fixed_hw=False) -> List[CameraInfo]:
    """dataset_readers.py:244-380 (both variants)."""
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)

    global_fov = None
    if "camera_angle_x" in contents:
        fovx = contents["camera_angle_x"]
        global_fov = ("angle", fovx, contents.get("camera_angle_y"))
    elif "fl_x" in contents:
        global_fov = ("focal", contents["fl_x"], contents["fl_y"])

    infos = []
    for idx, frame in enumerate(contents["frames"]):
        cam_name = frame["file_path"] + extension
        image_path = os.path.join(path, cam_name)
        image_name = Path(cam_name).stem

        # NeRF/Blender -> COLMAP axis flip (dataset_readers.py:264-268,331-336)
        matrix = np.array(frame["transform_matrix"], dtype=np.float64)
        matrix[:, 1:3] *= -1
        R = matrix[:3, :3]
        T = np.linalg.inv(matrix)[:3, 3]

        if fixed_hw and "w" in contents:
            w, h = int(contents["w"]), int(contents["h"])
        else:
            from PIL import Image
            with Image.open(image_path) as im:
                w, h = im.size

        if global_fov is None and "fl_x" in frame:
            FovX = focal2fov(frame["fl_x"], w)
            FovY = focal2fov(frame["fl_y"], h)
        elif global_fov[0] == "angle":
            FovX = global_fov[1]
            FovY = (global_fov[2] if global_fov[2] is not None
                    else focal2fov(fov2focal(FovX, w), h))
        else:
            FovX = focal2fov(global_fov[1], w)
            FovY = focal2fov(global_fov[2], h)

        infos.append(CameraInfo(
            uid=idx, R=R, T=T, FovY=FovY, FovX=FovX,
            image_path=image_path, image_name=image_name, width=w, height=h,
            depth_path=_sibling_path(image_path, "depth") if using_depth else None,
            seg_path=_sibling_path(image_path, "segment") if using_seg else None,
            white_background=white_background,
        ))
    return infos


def read_blender_scene(path, white_background=False, eval_split=False,
                       extension=".png", using_depth=False,
                       using_seg=False) -> SceneInfo:
    """transforms_train/test.json (dataset_readers.py:370-404)."""
    train = _cams_from_transforms(path, "transforms_train.json", white_background,
                                  extension, using_depth, using_seg)
    test = _cams_from_transforms(path, "transforms_test.json", white_background,
                                 extension, using_depth, using_seg)
    if not eval_split:
        train = train + test
        test = []
    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        store_ply(ply_path, xyz, sh_lib.sh_to_rgb_dc(shs) * 255)
    try:
        pcd = fetch_ply(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(pcd, train, test, norm, ply_path)


def read_nerfstudio_scene(path, eval_split=False, extension="", llffhold=8,
                          using_depth=False, using_seg=False) -> SceneInfo:
    """Single transforms.json (dataset_readers.py:407-447)."""
    infos = _cams_from_transforms(path, "transforms.json", False, extension,
                                  using_depth, using_seg, fixed_hw=True)
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    norm = get_nerfpp_norm(train)
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        xyz = (np.random.random((num_pts, 3)) * norm["radius"] - norm["translate"])
        shs = np.random.random((num_pts, 3)) / 255.0
        store_ply(ply_path, xyz, sh_lib.sh_to_rgb_dc(shs) * 255)
    try:
        pcd = fetch_ply(ply_path)
    except Exception:
        pcd = None
    return SceneInfo(pcd, train, test, norm, ply_path)


scene_load_type_callbacks = {
    "Colmap": read_colmap_scene,
    "Blender": read_blender_scene,
    "NeRFstudio": read_nerfstudio_scene,
}
