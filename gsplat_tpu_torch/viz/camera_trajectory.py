"""Camera motion & pose-interpolation utilities.

Behavioral spec: reference visual_res_app/camera_trajectory.py —
keyboard motion primitives (:29-247), bbox rotation bases (:309-414),
quaternion helpers (:416-492), slerp+lerp keyframe interpolation with
poses_render.npy save/replay (:507-575), and camera frustum wireframes for
overlays (:603-631).  Host-side numpy/scipy; consumed by the render CLI and
the offline visualizer.  A verbatim copy of
``gsplat_tpu/viz/camera_trajectory.py``: the port imports nothing of the JAX
package.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
from scipy.spatial.transform import Rotation, Slerp


# --- pose interpolation (camera_trajectory.py:507-575) -----------------------

def inter_poses(key_poses: Sequence[np.ndarray], n_out: int,
                sigma: float = 1.0, save_path: str | None = None) -> np.ndarray:
    """Interpolate a smooth path through 4x4 world-view (W2C, row-vector
    convention / transposed) keyframe matrices.  Returns [n_out, 4, 4].

    Rotations via slerp, translations via linear interpolation, matching the
    reference's scipy-based implementation."""
    key_poses = [np.asarray(p, np.float64) for p in key_poses]
    n_key = len(key_poses)
    if n_key == 1:
        out = np.repeat(key_poses[0][None], n_out, axis=0).astype(np.float32)
        if save_path:
            np.save(save_path, out)
        return out

    # The stored matrices are transposed W2V: recover rotation/translation.
    Rs = np.stack([p[:3, :3].T for p in key_poses])  # [n,3,3] true rotation
    ts = np.stack([p[3, :3] for p in key_poses])     # translation row

    key_times = np.linspace(0, 1, n_key)
    slerp = Slerp(key_times, Rotation.from_matrix(Rs))
    times = np.linspace(0, 1, n_out)
    R_interp = slerp(times).as_matrix()              # [n_out,3,3]
    t_interp = np.stack([
        np.interp(times, key_times, ts[:, i]) for i in range(3)], axis=1)

    out = np.zeros((n_out, 4, 4), np.float32)
    out[:, :3, :3] = R_interp.transpose(0, 2, 1)
    out[:, 3, :3] = t_interp
    out[:, 3, 3] = 1.0
    if save_path:
        np.save(save_path, out)
    return out


def load_poses(path: str) -> np.ndarray:
    """Replay GUI-saved poses (camera_trajectory.py:560-575)."""
    return np.load(path)


# --- incremental camera motion (camera_trajectory.py:29-247) -----------------

def translate(world_view: np.ndarray, dx=0.0, dy=0.0, dz=0.0,
              step: float = 0.1) -> np.ndarray:
    """Translate the camera along its own axes."""
    M = np.array(world_view, np.float32).copy()
    M[3, :3] += np.array([dx, dy, dz], np.float32) * step
    return M


def rotate(world_view: np.ndarray, axis: str, angle_deg: float) -> np.ndarray:
    """Rotate the camera about one of its own axes."""
    ang = np.deg2rad(angle_deg)
    c, s = np.cos(ang), np.sin(ang)
    if axis == "x":
        Rd = np.array([[1, 0, 0], [0, c, s], [0, -s, c]], np.float32)
    elif axis == "y":
        Rd = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    else:
        Rd = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    M = np.array(world_view, np.float32).copy()
    M[:3, :3] = M[:3, :3] @ Rd
    M[3, :3] = M[3, :3] @ Rd
    return M


def orbit(world_view: np.ndarray, yaw_deg: float, pitch_deg: float,
          center: np.ndarray | None = None) -> np.ndarray:
    """Mouse-orbit about a world-space pivot (camera_trajectory.py:250-307)."""
    center = np.zeros(3) if center is None else np.asarray(center)
    M = np.array(world_view, np.float64)
    W2C = M.T
    C2W = np.linalg.inv(W2C)
    pos = C2W[:3, 3] - center
    yaw = Rotation.from_euler("y", yaw_deg, degrees=True).as_matrix()
    pitch_axis = C2W[:3, 0]
    pitch = Rotation.from_rotvec(np.deg2rad(pitch_deg) * pitch_axis).as_matrix()
    Rot = pitch @ yaw
    new_pos = Rot @ pos + center
    new_rot = Rot @ C2W[:3, :3]
    C2W_new = np.eye(4)
    C2W_new[:3, :3] = new_rot
    C2W_new[:3, 3] = new_pos
    return np.linalg.inv(C2W_new).T.astype(np.float32)


# --- bbox rotation bases (camera_trajectory.py:309-414) ----------------------

def bbox_basis(rx_deg: float, ry_deg: float, rz_deg: float) -> np.ndarray:
    """Orthonormal basis for the visualizer's rotated crop box."""
    return Rotation.from_euler(
        "xyz", [rx_deg, ry_deg, rz_deg], degrees=True).as_matrix().astype(
        np.float32)


def bbox_mask(points: np.ndarray, center: np.ndarray, basis: np.ndarray,
              extents: np.ndarray) -> np.ndarray:
    """Containment mask of points inside a rotated box (visualizer.py:718-792
    bbox_clip): |basis^T (p - center)| <= extents per axis."""
    local = (points - center[None]) @ basis  # [P,3]
    return np.all(np.abs(local) <= extents[None], axis=1)


# --- quaternion helpers (camera_trajectory.py:416-492) -----------------------

def qvec_from_matrix(R: np.ndarray) -> np.ndarray:
    q = Rotation.from_matrix(R).as_quat()  # xyzw
    return np.array([q[3], q[0], q[1], q[2]])


def matrix_from_qvec(q: np.ndarray) -> np.ndarray:
    return Rotation.from_quat([q[1], q[2], q[3], q[0]]).as_matrix()


# --- overlays (camera_trajectory.py:603-631) ---------------------------------

def cam_frustum_points(world_view: np.ndarray, scale: float = 0.3) -> np.ndarray:
    """Wireframe corner points of a camera frustum in world space, for
    drawing camera poses in the viewer."""
    C2W = np.linalg.inv(np.asarray(world_view, np.float64).T)
    corners_cam = np.array([
        [0, 0, 0], [1, 1, 2], [1, -1, 2], [-1, -1, 2], [-1, 1, 2],
    ]) * scale
    pts = (C2W[:3, :3] @ corners_cam.T).T + C2W[:3, 3]
    return pts.astype(np.float32)
