"""Public render() API (PyTorch port of ``gsplat_tpu/renderer.py``).

Takes a Camera/MiniCam + GaussianModel and returns the reference render()
dict: {render, viewspace_points, visibility_filter, radii, depth, alpha,
segment}, with ``depth`` max-normalized like the reference
(gaussian_renderer/__init__.py:375) and the raw composited depth as
``depth_raw``.  ``bbox_mask`` suppresses masked-out gaussians;
``rgb_factors`` applies the appearance color correction.

Runs on the model's device, which must be the ``device`` argument
(default "cuda").
"""
from __future__ import annotations

from typing import Optional

import torch

from gsplat_tpu_torch.core import transforms as T
from gsplat_tpu_torch.device import check_on, resolve_device
from gsplat_tpu_torch.models.gaussians import GaussianModel
from gsplat_tpu_torch.ops import preprocess as pre_lib
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

# (P, W, H) -> instance capacity measured for the first frame of that
# shape.  Binning and the sort scale with the fixed capacity, so measure the
# demand once (one preprocess and one readback) and bucket it; later frames
# of the same shape reuse it, and the overflow flag guards the rest.
_capacity_cache: dict = {}


def _count_instances(cam, pc: GaussianModel, W: int, H: int,
                     scaling_modifier: float) -> int:
    dev = pc.device
    p = pc.params
    pre = pre_lib.preprocess(
        p.xyz, T.scaling_activation(p.scaling), p.rotation,
        T.opacity_activation(p.opacity[:, 0]), None, 0,
        torch.as_tensor(cam.world_view_transform, device=dev),
        torch.as_tensor(cam.full_proj_transform, device=dev),
        torch.as_tensor(cam.camera_center, device=dev),
        cam.tan_fovx, cam.tan_fovy, W, H,
        scale_modifier=scaling_modifier,
        colors_precomp=torch.zeros_like(p.xyz))
    return int(torch.sum(pre.tiles_touched, dtype=torch.int64))


def _auto_capacity(cam, pc: GaussianModel, W: int, H: int,
                   scaling_modifier: float) -> int:
    key = (pc.params.xyz.shape[0], W, H)
    if key in _capacity_cache:
        return _capacity_cache[key]
    nr = _count_instances(cam, pc, W, H, scaling_modifier)
    pads = 64 * ((W + 15) // 16) * ((H + 15) // 16)
    blk = 1 << 17
    # 1.6x headroom for view-dependent variation in later frames
    cap = max(1 << 18, (int(nr * 1.6) + pads + blk - 1) // blk * blk)
    _capacity_cache[key] = cap
    return cap


def render(
    viewpoint_camera,
    pc: GaussianModel,
    bg_color=None,
    scaling_modifier: float = 1.0,
    override_color: Optional[torch.Tensor] = None,
    bbox_mask: Optional[torch.Tensor] = None,
    rgb_factors: Optional[torch.Tensor] = None,
    backend: str = "auto",
    max_instances: int = 0,
    means2d_offset: Optional[torch.Tensor] = None,
    active_sh_degree: Optional[int] = None,
    convert_SHs_python: bool = False,
    compute_cov3D_python: bool = False,
    device="cuda",
):
    dev = resolve_device(device)
    check_on(dev, xyz=pc.params.xyz)
    bg = (torch.zeros(3, device=dev) if bg_color is None
          else torch.as_tensor(bg_color, dtype=torch.float32, device=dev))
    W = int(viewpoint_camera.image_width)
    H = int(viewpoint_camera.image_height)
    if max_instances <= 0:
        max_instances = _auto_capacity(viewpoint_camera, pc, W, H,
                                       scaling_modifier)
    sh_deg = pc.active_sh_degree if active_sh_degree is None else active_sh_degree

    cfg = RasterizeConfig(
        width=W, height=H, sh_degree=sh_deg, num_class=pc.num_class,
        max_instances=max_instances, backend=backend,
    )
    p = pc.params
    opac = T.opacity_activation(p.opacity[:, 0])
    if bbox_mask is not None:
        opac = torch.where(torch.as_tensor(bbox_mask, device=dev), opac, 0.0)

    # pipe.compute_cov3D_python / convert_SHs_python: feed the covariance
    # and SH->RGB computed here as precomputed inputs, like the reference's
    # debug backends (gaussian_renderer/__init__.py:341-359)
    cov3d_precomp = None
    if compute_cov3D_python:
        cov3d_precomp = T.covariance_from_scaling_rotation(
            T.scaling_activation(p.scaling), scaling_modifier, p.rotation)
    if override_color is None and convert_SHs_python:
        from gsplat_tpu_torch.core import sh as sh_lib
        override_color = sh_lib.sh_to_rgb(
            sh_deg, pc.get_features, p.xyz,
            torch.as_tensor(viewpoint_camera.camera_center, device=dev))

    out = rasterize(
        cfg, p.xyz, T.scaling_activation(p.scaling), p.rotation, opac,
        pc.get_features,
        viewmatrix=viewpoint_camera.world_view_transform,
        projmatrix=viewpoint_camera.full_proj_transform,
        campos=viewpoint_camera.camera_center,
        tan_fovx=viewpoint_camera.tan_fovx,
        tan_fovy=viewpoint_camera.tan_fovy,
        bg=bg,
        segments=T.segment_activation(p.segment),
        means2d_offset=means2d_offset,
        scale_modifier=scaling_modifier,
        colors_precomp=override_color,
        cov3d_precomp=cov3d_precomp,
        device=dev,
    )
    image = out["render"]
    if rgb_factors is not None:
        image = image * torch.as_tensor(rgb_factors, device=dev).reshape(3, 1, 1)

    depth_raw = out["depth"]
    depth = depth_raw / (torch.max(depth_raw) + 1e-5)  # reference :375

    return {
        "render": image,
        "viewspace_points": means2d_offset,
        "visibility_filter": out["visibility"],
        "radii": out["radii"],
        "depth": depth,
        "depth_raw": depth_raw,
        "alpha": out["alpha"],
        "segment": out.get("segment"),
        "overflow": out["overflow"],
        "num_rendered": out["num_rendered"],
    }
