"""Per-gaussian preprocessing: frustum cull, projection, EWA 2D covariance,
conic, screen radius, opacity-aware tile rect, SH->RGB.

PyTorch port of ``gsplat_tpu/ops/preprocess.py``; behavioral spec is the
reference forward.cu:74-256 and auxiliary.h:40-56,137-164.  Embarrassingly
parallel over P, so it stays plain elementwise PyTorch (the JAX package
leaves it to XLA fusion too).  Everything is fp32 and written in the same
operation order as the JAX package, so the integer outputs (radii, rects,
tiles_touched, visible) agree exactly and the float outputs to rounding.

The matrices are stored transposed (row-vector convention): points
transform as ``p_row @ M`` — see core/cameras.py.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch import tracing
from gsplat_tpu_torch.core import sh as sh_lib
from gsplat_tpu_torch.core import transforms as T

# Tile shape, snapshotted at import from the same environment variables as
# the JAX package (set them BEFORE importing): GSPLAT_TILE_X / GSPLAT_TILE_Y.
# Default 32x32; the composite kernel runs one thread per tile pixel, so
# TILE_X * TILE_Y must not exceed 1024.
TILE_X = int(os.environ.get("GSPLAT_TILE_X", "32"))
TILE_Y = int(os.environ.get("GSPLAT_TILE_Y", "32"))


class PreprocessOut(NamedTuple):
    depths: torch.Tensor         # [P] view-space z
    radii: torch.Tensor          # [P] int32 screen-space radius (0 = culled)
    means2d: torch.Tensor        # [P,2] pixel coords
    conic: torch.Tensor          # [P,3] inverse 2D covariance (a,b,c)
    rgb: torch.Tensor            # [P,3] SH-evaluated color (or override)
    opacity: torch.Tensor        # [P] activated opacity
    tiles_touched: torch.Tensor  # [P] int32 count of touched tiles
    rect_min: torch.Tensor       # [P,2] int32 (tx,ty) inclusive
    rect_max: torch.Tensor       # [P,2] int32 exclusive
    visible: torch.Tensor        # [P] bool (radii > 0)


def ndc2pix(v, S):
    """auxiliary.h:40-43."""
    return ((v + 1.0) * S - 1.0) * 0.5


def transform_point_4x3(p, M):
    """p_row @ M, first 3 components (auxiliary.h:57-66), component-wise."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = [x * M[0, j] + y * M[1, j] + z * M[2, j] + M[3, j] for j in range(3)]
    return torch.stack(out, dim=-1)


def transform_point_4x4(p, M):
    """p_row @ M homogeneous (auxiliary.h:68-77), component-wise."""
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    out = [x * M[0, j] + y * M[1, j] + z * M[2, j] + M[3, j] for j in range(4)]
    return torch.stack(out, dim=-1)


def compute_cov2d(means3d, cov3d6, focal_x, focal_y, tan_fovx, tan_fovy,
                  viewmatrix, clamp_tan_fovx=None, clamp_tan_fovy=None):
    """EWA-project 3D covariances to 2D (forward.cu:74-113).

    Returns [P,3] packed (cov_xx, cov_xy, cov_yy) with the +0.3 low-pass.
    """
    t = transform_point_4x3(means3d, viewmatrix)
    limx = 1.3 * (tan_fovx if clamp_tan_fovx is None else clamp_tan_fovx)
    limy = 1.3 * (tan_fovy if clamp_tan_fovy is None else clamp_tan_fovy)
    tz = t[:, 2]
    txtz = t[:, 0] / tz
    tytz = t[:, 1] / tz
    tx = torch.clamp(txtz, -limx, limx) * tz
    ty = torch.clamp(tytz, -limy, limy) * tz

    # J has 4 nonzero entries; T = W @ J column-wise (see the JAX module)
    W = viewmatrix[:3, :3]
    # 0-d tensors, not Python floats: ``float / tensor`` is evaluated as
    # reciprocal(tensor) * float in PyTorch, one rounding more than XLA's
    # true division.  On a card each copy from the host waits for the queue.
    with tracing.span("sync"):
        fx = tz.new_tensor(focal_x)
        fy = tz.new_tensor(focal_y)
    j00 = fx / tz
    j11 = fy / tz
    j02 = -(fx * tx) / (tz * tz)
    j12 = -(fy * ty) / (tz * tz)

    t0 = [W[i, 0] * j00 + W[i, 2] * j02 for i in range(3)]
    t1 = [W[i, 1] * j11 + W[i, 2] * j12 for i in range(3)]

    v_xx, v_xy, v_xz = cov3d6[:, 0], cov3d6[:, 1], cov3d6[:, 2]
    v_yy, v_yz, v_zz = cov3d6[:, 3], cov3d6[:, 4], cov3d6[:, 5]

    def vrk_dot(a, b):
        return (a[0] * (v_xx * b[0] + v_xy * b[1] + v_xz * b[2])
                + a[1] * (v_xy * b[0] + v_yy * b[1] + v_yz * b[2])
                + a[2] * (v_xz * b[0] + v_yz * b[1] + v_zz * b[2]))

    cov_xx = vrk_dot(t0, t0) + 0.3
    cov_xy = vrk_dot(t0, t1)
    cov_yy = vrk_dot(t1, t1) + 0.3
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def _tile_coord(v, n: int):
    """int32(v) clipped to [0, n] with XLA's float->int conversion
    semantics (truncate toward zero, saturate, NaN -> 0), which a plain
    ``.to(torch.int32)`` leaves undefined out of range."""
    v = torch.clamp(torch.nan_to_num(v, nan=0.0), -1.0, n + 1.0)
    return torch.clamp(v.to(torch.int32), 0, n)


def preprocess(
    means3d: torch.Tensor,            # [P,3]
    scales: torch.Tensor,             # [P,3] activated (exp applied)
    rotations: torch.Tensor,          # [P,4] raw quaternions
    opacities: torch.Tensor,          # [P] activated (sigmoid applied)
    shs: Optional[torch.Tensor],      # [P,K,3] or None
    sh_degree: int,
    viewmatrix: torch.Tensor,         # [4,4] transposed W2V
    projmatrix: torch.Tensor,         # [4,4] transposed full projection
    campos: torch.Tensor,             # [3]
    tan_fovx,
    tan_fovy,
    width: int,
    height: int,
    scale_modifier: float = 1.0,
    cov3d_precomp: Optional[torch.Tensor] = None,   # [P,6]
    colors_precomp: Optional[torch.Tensor] = None,  # [P,3]
    clamp_tan_fovx=None,
    clamp_tan_fovy=None,
    full_width: Optional[int] = None,
    full_height: Optional[int] = None,
    pixel_offset=(0, 0),
) -> PreprocessOut:
    """``full_width/full_height`` + ``pixel_offset``: render a (width,
    height) crop of a larger camera in full-image pixel space; focal,
    ndc2pix and the projection use the full dims, then pixel coordinates
    shift by the integer offset (a multiple of TILE_X/TILE_Y)."""
    fw = width if full_width is None else full_width
    fh = height if full_height is None else full_height
    focal_y = fh / (2.0 * tan_fovy)   # rasterizer_impl.cu:226-227
    focal_x = fw / (2.0 * tan_fovx)

    grid_x = (width + TILE_X - 1) // TILE_X
    grid_y = (height + TILE_Y - 1) // TILE_Y

    # Frustum cull (auxiliary.h:137-164): view z > 0.2 required.
    p_view = transform_point_4x3(means3d, viewmatrix)
    in_frustum = p_view[:, 2] > 0.2

    # Project (forward.cu:197-200).
    p_hom = transform_point_4x4(means3d, projmatrix)
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]

    if cov3d_precomp is not None:
        cov3d6 = cov3d_precomp
    else:
        cov3d6 = T.covariance_from_scaling_rotation(scales, scale_modifier,
                                                    rotations)

    # 2D covariance -> conic (forward.cu:219-227).
    cov2d = compute_cov2d(
        means3d, cov3d6, focal_x, focal_y, tan_fovx, tan_fovy, viewmatrix,
        clamp_tan_fovx, clamp_tan_fovy,
    )
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_ok = det != 0.0
    det_inv = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack(
        [cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv, cov2d[:, 0] * det_inv],
        dim=-1,
    )

    # Screen-space radius from max eigenvalue (forward.cu:229-233).
    mid = 0.5 * (cov2d[:, 0] + cov2d[:, 2])
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lam2 = mid - torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(torch.maximum(lam1, lam2)))

    point_image = torch.stack(
        [ndc2pix(p_proj[:, 0], fw) - pixel_offset[0],
         ndc2pix(p_proj[:, 1], fh) - pixel_offset[1]], dim=-1
    )

    # Opacity-aware tile rect (the JAX module's refinement of auxiliary.h:
    # 45-56): per-axis extents sqrt(2 Sigma_ii ln(255 op)) + 1 px, capped at
    # the CUDA 3-sigma radius; tiles outside contribute exactly nothing.
    ln_op = torch.log(torch.clamp(255.0 * opacities, min=1.0))
    ext_x = torch.minimum(radius, torch.sqrt(2.0 * cov2d[:, 0] * (ln_op + 1e-3)) + 1.0)
    ext_y = torch.minimum(radius, torch.sqrt(2.0 * cov2d[:, 2] * (ln_op + 1e-3)) + 1.0)
    rect_min_x = _tile_coord((point_image[:, 0] - ext_x) / TILE_X, grid_x)
    rect_min_y = _tile_coord((point_image[:, 1] - ext_y) / TILE_Y, grid_y)
    rect_max_x = _tile_coord((point_image[:, 0] + ext_x + TILE_X - 1) / TILE_X, grid_x)
    rect_max_y = _tile_coord((point_image[:, 1] + ext_y + TILE_Y - 1) / TILE_Y, grid_y)
    tiles = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y)

    valid = in_frustum & det_ok & (tiles > 0)
    radii = torch.where(valid, radius, 0.0).to(torch.int32)
    tiles_touched = torch.where(valid, tiles, 0).to(torch.int32)

    # Color (forward.cu:238-246).
    if colors_precomp is not None:
        rgb = colors_precomp
    else:
        rgb = sh_lib.sh_to_rgb(sh_degree, shs, means3d, campos)

    return PreprocessOut(
        depths=p_view[:, 2],
        radii=radii,
        means2d=point_image,
        conic=conic,
        rgb=rgb,
        opacity=opacities,
        tiles_touched=tiles_touched,
        rect_min=torch.stack([rect_min_x, rect_min_y], dim=-1),
        rect_max=torch.stack([rect_max_x, rect_max_y], dim=-1),
        visible=valid,
    )
