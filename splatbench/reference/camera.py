"""Pinhole cameras as 3DGS builds them (graphics_utils.getWorld2View2 and
getProjectionMatrix, scene/cameras.py), and the poses of the benchmark's
traffic: a rotation about the scene's vertical axis and a tilt, at the
translation of the bench camera, so every pose sees the scene's origin at
one distance."""
from __future__ import annotations

import math

import numpy as np
import torch

from splatbench.reference.splat import Cam

ZNEAR, ZFAR = 0.01, 100.0


def world_to_view(R, t):
    """The 4x4 world-to-view matrix of a camera whose camera-to-world
    rotation is ``R`` and world-to-camera translation ``t``."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def projection(fovx, fovy, znear=ZNEAR, zfar=ZFAR):
    top = math.tan(fovy / 2) * znear
    right = math.tan(fovx / 2) * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov_y(fovx: float, width: int, height: int) -> float:
    return 2 * math.atan(math.tan(fovx / 2) * height / width)


def matrices(pose: dict, width: int, height: int):
    """(view, full projection, camera centre) in row-vector form, float32."""
    view = world_to_view(np.asarray(pose["R"]),
                         np.asarray(pose["T"])).transpose().astype(np.float32)
    proj = projection(pose["fovx"], pose["fovy"]).transpose().astype(
        np.float32)
    full = (view @ proj).astype(np.float32)
    centre = np.linalg.inv(view)[3, :3].astype(np.float32)
    return view, full, centre


def cam(pose: dict, width: int, height: int, device, dtype=torch.float32):
    view, full, centre = matrices(pose, width, height)

    def t(x):
        return torch.as_tensor(x, device=device).to(dtype)

    return Cam(t(view), t(full), t(centre), math.tan(pose["fovx"] * 0.5),
               math.tan(pose["fovy"] * 0.5), width, height)


def rotation(yaw_deg: float, pitch_deg: float):
    """Camera-to-world rotation: a turn about the vertical axis, then a
    tilt about the camera's horizontal axis."""
    y, p = math.radians(yaw_deg), math.radians(pitch_deg)
    Ry = np.array([[math.cos(y), 0.0, math.sin(y)], [0.0, 1.0, 0.0],
                   [-math.sin(y), 0.0, math.cos(y)]])
    Rx = np.array([[1.0, 0.0, 0.0], [0.0, math.cos(p), -math.sin(p)],
                   [0.0, math.sin(p), math.cos(p)]])
    return Ry @ Rx


def poses(spec: dict, width: int, height: int) -> list:
    """``spec["count"]`` poses with yaw and pitch drawn uniformly within
    +-``yaw_deg`` and +-``pitch_deg`` from ``numpy.random.default_rng(
    spec["seed"])``, the first one at yaw and pitch 0."""
    rng = np.random.default_rng(spec["seed"])
    n = spec["count"]
    yaw = rng.uniform(-spec["yaw_deg"], spec["yaw_deg"], n)
    pitch = rng.uniform(-spec["pitch_deg"], spec["pitch_deg"], n)
    yaw[0] = pitch[0] = 0.0
    fovx = math.radians(spec["fovx_deg"])
    fovy = fov_y(fovx, width, height)
    return [dict(R=rotation(float(a), float(b)), T=list(spec["T"]),
                 fovx=fovx, fovy=fovy, yaw=float(a), pitch=float(b))
            for a, b in zip(yaw, pitch)]
