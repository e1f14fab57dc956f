"""Data-preparation converters (PyTorch port's copy of
``gsplat_tpu/data/converters.py``; numpy and PIL only, kept as a copy
because the port imports nothing of the JAX package).  Every file it
writes (JSON text, ``.npy`` bytes, PNGs) is the JAX module's.

Behavioral spec: reference process_data/*.py:
- slam2nerf:   SLAM ``KeyFramePose.txt``/``Pose.txt`` -> nerfstudio
               transforms.json, including sequential block splitting and the
               localrf-style distance-threshold block sequencing
               (slam2nerf.py:50-265).
- nerf2poses:  transforms.json -> LLFF poses_bounds.npy (nerf2poses.py).
- polycam:     polycam export -> LLFF poses_bounds (gen_poses_bounds_from_
               polycam.py).
- depth norm:  16-bit depth PNG normalization (handle_slam_depth2norm.py).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _slam_pose_to_nerf(vals: Sequence[float]) -> np.ndarray:
    """3x4 row-major SLAM pose -> 4x4 nerf c2w with the COLMAP->NeRF axis
    flip (slam2nerf.py:9-19)."""
    pose = np.array(vals, dtype=np.float32).reshape(3, -1)
    pose = np.concatenate([pose, np.array([[0, 0, 0, 1]], np.float32)])
    pose[:3, 1:3] *= -1
    return pose


def read_slam_poses(path: str) -> Dict[str, np.ndarray]:
    """Parse ``<img_id> r00 r01 ... t2`` lines."""
    out = {}
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            out[t[0]] = _slam_pose_to_nerf([float(x) for x in t[1:]])
    return out


def slam_to_nerf(root_dir: str, intrinsics: dict,
                 pose_file: str = "KeyFramePose.txt",
                 image_ext: str = "jpg",
                 out_path: Optional[str] = None) -> str:
    """SLAM poses -> nerfstudio transforms.json (slam2nerf.py:50-87).

    ``intrinsics`` needs fl_x, fl_y, cx, cy, w, h (+optional k1,k2,p1,p2)."""
    poses = read_slam_poses(os.path.join(root_dir, pose_file))
    data = dict(
        fl_x=intrinsics["fl_x"], fl_y=intrinsics["fl_y"],
        k1=intrinsics.get("k1", 0.0), k2=intrinsics.get("k2", 0.0),
        k3=0, k4=0,
        p1=intrinsics.get("p1", 0.0), p2=intrinsics.get("p2", 0.0),
        is_fisheye=False,
        cx=intrinsics["cx"], cy=intrinsics["cy"],
        w=intrinsics["w"], h=intrinsics["h"],
        aabb_scale=16,
    )
    data["frames"] = [
        {"file_path": f"images/{img_id}.{image_ext}",
         "transform_matrix": [row.tolist() for row in pose]}
        for img_id, pose in poses.items()
    ]
    out_path = out_path or os.path.join(root_dir, "transforms.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=4)
    return out_path


def compute_block_seq(root_dir: str, K: float = 16.0,
                      pose_file: str = "Pose.txt") -> List[List[List[int]]]:
    """localrf-style distance-threshold block sequencing
    (slam2nerf.py:160-196): start a new block whenever the camera travels
    more than K from the block start; blocks overlap from the midpoint."""
    with open(os.path.join(root_dir, pose_file)) as f:
        lines = [ln for ln in f if ln.strip()]
    block_seq: List[List[List[int]]] = []
    t_by_id: Dict[str, np.ndarray] = {}
    start = None
    for idx, line in enumerate(lines):
        img_id, *vals = line.split()
        T = _slam_pose_to_nerf([float(x) for x in vals])[:3, -1]
        t_by_id[img_id] = T
        if idx == 0:
            start = [int(img_id), T]
        distance = float(np.linalg.norm(T - start[1]))
        if distance > K:
            block_seq.append([[start[0], int(img_id)]])
            start = [(int(img_id) + start[0]) // 2, T]
    last_id = int(lines[-1].split()[0])
    if not block_seq:
        block_seq.append([[start[0], last_id]])
    elif last_id not in block_seq[-1][0]:
        block_seq.append(
            [[(block_seq[-1][0][0] + block_seq[-1][0][1]) // 2, last_id]])
    return block_seq


def split_blocks(root_dir: str, intrinsics: dict,
                 block_space_split: List[List[List[int]]],
                 pose_file: str = "KeyFramePose.txt",
                 image_ext: str = "jpg", copy_images: bool = True) -> List[str]:
    """Write one block_<i>/ dataset per id-range group
    (slam2nerf.py:90-143)."""
    poses = read_slam_poses(os.path.join(root_dir, pose_file))
    outs = []
    for idx, ranges in enumerate(block_space_split):
        block_dir = os.path.join(root_dir, f"block_{idx}")
        os.makedirs(os.path.join(block_dir, "images"), exist_ok=True)
        frames = []
        for start, end in ranges:
            for img_id, pose in poses.items():
                if start <= int(img_id) <= end:
                    frames.append({
                        "file_path": f"./images/{img_id}.{image_ext}",
                        "transform_matrix": [r.tolist() for r in pose],
                    })
                    src = os.path.join(root_dir, "images",
                                       f"{img_id}.{image_ext}")
                    if copy_images and os.path.exists(src):
                        shutil.copy(src, os.path.join(block_dir, "images"))
        data = dict(intrinsics)
        data.setdefault("aabb_scale", 16)
        data["frames"] = frames
        out = os.path.join(block_dir, "transforms.json")
        with open(out, "w", encoding="utf-8") as f:
            json.dump(data, f, indent=4)
        outs.append(out)
    return outs


def nerf_to_poses_bounds(transforms_path: str,
                         near: float = 0.1, far: float = 100.0,
                         out_path: Optional[str] = None) -> str:
    """transforms.json -> LLFF poses_bounds.npy (nerf2poses.py): per frame a
    3x5 [R|t|hwf] matrix (with the LLFF [down,right,back]->[right,up,back]
    column swizzle) plus near/far bounds."""
    with open(transforms_path) as f:
        meta = json.load(f)
    h = meta.get("h")
    w = meta.get("w")
    focal = meta.get("fl_x") or (
        0.5 * w / np.tan(0.5 * meta["camera_angle_x"]))
    rows = []
    for frame in meta["frames"]:
        c2w = np.array(frame["transform_matrix"], np.float64)
        # nerf (right, up, back) -> llff (down, right, back)
        m = np.concatenate(
            [-c2w[:3, 1:2], c2w[:3, 0:1], c2w[:3, 2:3], c2w[:3, 3:4]], axis=1)
        hwf = np.array([[h], [w], [focal]], np.float64)
        rows.append(np.concatenate([m, hwf], axis=1).ravel().tolist()
                    + [near, far])
    arr = np.array(rows)
    out_path = out_path or os.path.join(
        os.path.dirname(transforms_path), "poses_bounds.npy")
    np.save(out_path, arr)
    return out_path


def polycam_to_poses_bounds(polycam_dir: str,
                            out_path: Optional[str] = None) -> str:
    """Polycam keyframe export -> LLFF poses_bounds
    (gen_poses_bounds_from_polycam.py).  Expects
    ``keyframes/cameras/*.json`` with t_0x..t_2z rows + fx/fy/cx/cy/width/
    height."""
    cam_dir = os.path.join(polycam_dir, "keyframes", "cameras")
    rows = []
    for name in sorted(os.listdir(cam_dir)):
        with open(os.path.join(cam_dir, name)) as f:
            c = json.load(f)
        c2w = np.array([
            [c["t_00"], c["t_01"], c["t_02"], c["t_03"]],
            [c["t_10"], c["t_11"], c["t_12"], c["t_13"]],
            [c["t_20"], c["t_21"], c["t_22"], c["t_23"]],
        ])
        m = np.concatenate(
            [-c2w[:3, 1:2], c2w[:3, 0:1], c2w[:3, 2:3], c2w[:3, 3:4]], axis=1)
        hwf = np.array([[c["height"]], [c["width"]], [c["fx"]]])
        rows.append(np.concatenate([m, hwf], axis=1).ravel().tolist()
                    + [0.1, 100.0])
    arr = np.array(rows)
    out_path = out_path or os.path.join(polycam_dir, "poses_bounds.npy")
    np.save(out_path, arr)
    return out_path


def normalize_depth_folder(depth_dir: str, out_dir: Optional[str] = None):
    """Normalize 16-bit depth PNGs to the full uint16 range
    (handle_slam_depth2norm.py)."""
    from PIL import Image

    out_dir = out_dir or depth_dir
    os.makedirs(out_dir, exist_ok=True)
    for name in sorted(os.listdir(depth_dir)):
        if not name.lower().endswith(".png"):
            continue
        path = os.path.join(depth_dir, name)
        d = np.asarray(Image.open(path)).astype(np.float64)
        dmax = d.max() if d.max() > 0 else 1.0
        dn = (d / dmax * 65535.0).astype(np.uint16)
        Image.fromarray(dn).save(os.path.join(out_dir, name))
