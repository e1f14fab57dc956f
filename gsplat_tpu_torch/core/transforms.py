"""Quaternion / covariance / activation math for gaussians (PyTorch port of
``gsplat_tpu/core/transforms.py``).

Behavioral spec: reference forward.cu:118-152 (computeCov3D),
utils/general_utils.py:86-103 (build_rotation) and
scene/gaussian_model.py:27-43 (activations).  Batched over the leading
axis, fp32, written component-wise in the same operation order as the JAX
package so the two agree to rounding.
"""
from __future__ import annotations

import torch


def inverse_sigmoid(x):
    """Logit. Reference: utils/general_utils.py:18."""
    return torch.log(x / (1.0 - x))


def normalize(v, dim=-1, eps=1e-12):
    """L2-normalize along ``dim`` (torch.nn.functional.normalize semantics)."""
    n = torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))
    return v / torch.clamp(n, min=eps)


def _rot_entries(q):
    """The nine entries of the rotation of the normalized quaternion (wxyz)."""
    q = normalize(q, dim=-1)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return [
        [1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)],
        [2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)],
        [2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)],
    ]


def quat_to_rotmat(q):
    """Unit quaternion (wxyz) -> rotation matrix, [..., 4] -> [..., 3, 3],
    normalizing first like build_rotation."""
    R = _rot_entries(q)
    return torch.stack([torch.stack(row, dim=-1) for row in R], dim=-2)


def build_scaling_rotation(s, q):
    """L = R @ diag(s), batched (utils/general_utils.py:105-118)."""
    return quat_to_rotmat(q) * s[..., None, :]


def covariance_from_scaling_rotation(scaling, scaling_modifier, rotation):
    """World-space 3D covariance Sigma = R S S^T R^T, packed as the 6
    upper-triangular entries [xx, xy, xz, yy, yz, zz]."""
    R = _rot_entries(rotation)
    s2 = [(scaling[..., j] * scaling_modifier) ** 2 for j in range(3)]

    def sigma(a, b):
        return (R[a][0] * R[b][0] * s2[0] + R[a][1] * R[b][1] * s2[1]
                + R[a][2] * R[b][2] * s2[2])

    return torch.stack(
        [sigma(0, 0), sigma(0, 1), sigma(0, 2),
         sigma(1, 1), sigma(1, 2), sigma(2, 2)], dim=-1)


def strip_symmetric(S):
    """[..., 3, 3] symmetric -> packed [..., 6] (xx, xy, xz, yy, yz, zz)
    (utils/general_utils.py:72-84)."""
    return torch.stack(
        [S[..., 0, 0], S[..., 0, 1], S[..., 0, 2],
         S[..., 1, 1], S[..., 1, 2], S[..., 2, 2]], dim=-1)


def unpack_symmetric(c6):
    """Packed [..., 6] -> full [..., 3, 3] symmetric matrix."""
    xx, xy, xz, yy, yz, zz = (c6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


# --- parameter activations (scene/gaussian_model.py:27-43) -------------------
scaling_activation = torch.exp
scaling_inverse_activation = torch.log
opacity_activation = torch.sigmoid
segment_activation = torch.sigmoid
inverse_opacity_activation = inverse_sigmoid
rotation_activation = normalize
