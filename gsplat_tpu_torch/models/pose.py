"""Camera pose optimizer: per-camera 6-DoF SO(3)xR^3 exp-map deltas
(PyTorch port of ``gsplat_tpu/models/pose.py``).

Behavioral spec: reference gaussian_renderer/__init__.py:34-110
(CameraOptimizer; present but commented out of the reference train loop,
train.py:38-39,186-187).  A learned tangent vector [omega | t] per camera
perturbs the world-view transform: W2C' = exp([omega]_x) W2C + t.  Nothing
in either package's train loop calls it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch.device import resolve_device
from gsplat_tpu_torch.models import adam


class PoseParams(NamedTuple):
    deltas: torch.Tensor  # [num_cameras, 6] (so3 omega, translation)


def so3_exp(omega):
    """Rodrigues exp map, safe near zero: the exact identity below a
    rotation of 1e-9."""
    theta = torch.clamp(torch.linalg.norm(omega, dim=-1, keepdim=True),
                        min=1e-12)
    k = omega / theta
    zero = torch.zeros((), dtype=omega.dtype, device=omega.device)
    K = torch.stack([
        torch.stack([zero, -k[2], k[1]]),
        torch.stack([k[2], zero, -k[0]]),
        torch.stack([-k[1], k[0], zero]),
    ])
    th = theta[0]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where(th < 1e-9, eye, R)


def apply_pose_delta(params: PoseParams, cam_uid, world_view_transform):
    """Perturb a (transposed, row-vector convention) world-view matrix."""
    d = params.deltas[cam_uid]
    R_delta = so3_exp(d[:3])
    W2C = world_view_transform.T  # un-transpose, perturb, re-transpose
    out = torch.eye(4, dtype=W2C.dtype, device=W2C.device)
    out[:3, :3] = R_delta @ W2C[:3, :3]
    out[:3, 3] = W2C[:3, 3] + d[3:]
    return out.T


class CameraOptimizer:
    """Host container mirroring the reference's CameraOptimizer."""

    def __init__(self, num_cameras: int, lr: float = 1e-4, device="cuda"):
        self.num_cameras = num_cameras
        self.lr = lr
        self.device = resolve_device(device)
        self.params = PoseParams(deltas=torch.zeros(
            (num_cameras, 6), dtype=torch.float32, device=self.device))
        self.opt_state = adam.init(self.params)

    def __call__(self, viewpoint_cam):
        return apply_pose_delta(
            self.params, int(viewpoint_cam.uid),
            torch.as_tensor(viewpoint_cam.world_view_transform,
                            dtype=torch.float32, device=self.device))

    def update(self, grads):
        lrs = tuple(self.lr for _ in self.params)
        self.params, self.opt_state = adam.update(
            grads, self.opt_state, self.params, lrs)
