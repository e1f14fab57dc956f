"""Camera types and view/projection matrices.

Behavioral spec: reference scene/cameras.py:17-92 and
utils/graphics_utils.py:38-74.  Matrices follow the reference's row-vector
convention: they are stored TRANSPOSED so points transform as
``p_row @ M`` (matching the flat-float indexing in auxiliary.h:57-77).
Everything here is host-side numpy; arrays are shipped to device by the
renderer.  A verbatim copy of ``gsplat_tpu/core/cameras.py``: the port
imports nothing of the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def get_world2view2(R, t, translate=np.array([0.0, 0.0, 0.0]), scale=1.0):
    """World->view 4x4 (pre-transpose form). Reference graphics_utils.py:38-49."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def get_projection_matrix(znear, zfar, fovX, fovY):
    """OpenGL-style perspective (pre-transpose form).
    Reference graphics_utils.py:51-74 (z in [0, zfar/(zfar-znear)] range)."""
    tanHalfFovY = math.tan(fovY / 2)
    tanHalfFovX = math.tan(fovX / 2)
    top = tanHalfFovY * znear
    right = tanHalfFovX * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclass
class Camera:
    """A training/eval camera with its GT image (and optional depth/segment).

    ``world_view_transform`` / ``projection_matrix`` / ``full_proj_transform``
    are stored transposed (row-vector form) exactly like the reference
    (scene/cameras.py:59-62).
    """

    colmap_id: int
    R: np.ndarray          # [3,3] c2w rotation (COLMAP qvec convention, transposed)
    T: np.ndarray          # [3] w2c translation
    FoVx: float
    FoVy: float
    image: np.ndarray      # [3,H,W] float32 in [0,1]
    image_name: str
    uid: int
    gt_alpha_mask: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None    # [1,H,W] or [H,W]
    segment: Optional[np.ndarray] = None  # [H,W] int labels
    trans: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: float = 1.0
    znear: float = 0.01
    zfar: float = 100.0

    def __post_init__(self):
        self.image = np.clip(np.asarray(self.image, dtype=np.float32), 0.0, 1.0)
        if self.gt_alpha_mask is not None:
            self.image = self.image * np.asarray(self.gt_alpha_mask, np.float32)
        self.image_height = int(self.image.shape[1])
        self.image_width = int(self.image.shape[2])
        self._build_matrices()

    def _build_matrices(self):
        self.world_view_transform = get_world2view2(
            self.R, self.T, self.trans, self.scale
        ).transpose().astype(np.float32)
        self.projection_matrix = get_projection_matrix(
            self.znear, self.zfar, self.FoVx, self.FoVy
        ).transpose().astype(np.float32)
        self.full_proj_transform = (
            self.world_view_transform @ self.projection_matrix
        ).astype(np.float32)
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3].astype(
            np.float32
        )

    @property
    def K(self):
        fx = fov2focal(self.FoVx, self.image_width)
        fy = fov2focal(self.FoVy, self.image_height)
        return np.array(
            [[fx, 0, self.image_width / 2], [0, fy, self.image_height / 2], [0, 0, 1]],
            dtype=np.float32,
        )

    @property
    def tan_fovx(self):
        return math.tan(self.FoVx * 0.5)

    @property
    def tan_fovy(self):
        return math.tan(self.FoVy * 0.5)


class MiniCam:
    """Pose-only camera (GUI / path interpolation).

    Reference scene/cameras.py:73-92."""

    def __init__(self, width, height, fovy, fovx, znear, zfar,
                 world_view_transform, full_proj_transform):
        self.image_width = int(width)
        self.image_height = int(height)
        self.FoVy = fovy
        self.FoVx = fovx
        self.znear = znear
        self.zfar = zfar
        self.world_view_transform = np.asarray(world_view_transform, np.float32)
        self.full_proj_transform = np.asarray(full_proj_transform, np.float32)
        self.camera_center = np.linalg.inv(self.world_view_transform)[3, :3].astype(
            np.float32
        )

    @property
    def tan_fovx(self):
        return math.tan(self.FoVx * 0.5)

    @property
    def tan_fovy(self):
        return math.tan(self.FoVy * 0.5)
