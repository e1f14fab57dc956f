"""Tile-sharded rendering and training: one image split over ranks by tile
rows (PyTorch port of ``gsplat_tpu/parallel/tile_parallel.py``).

Each rank rasterizes rows ``[r*H/D, (r+1)*H/D)`` of the full camera through
the crop path of ``ops/preprocess.py`` (``full_width``, ``full_height``,
``pixel_offset``): focal, ndc2pix, the EWA clamps and the tile rects use the
full camera, then the pixel coordinates shift by the slice's row offset, a
multiple of ``TILE_Y``.  The slice's instances and every per-instance value
are those of the full render restricted to the slice, so the gathered
slices equal the single-device render bit for bit.

Training (``make_tile_sharded_train_step``).  The JAX step differentiates
through ``shard_map``.  Here each rank gathers the slices without autograd
and computes the same full-image loss (L1, SSIM across the slice seams,
depth normalised by the full maximum) from leaves that require a gradient;
it then backpropagates its own rows of that gradient through its slice
render, and the parameter and means2d gradients are summed over the tile
group (the JAX VJP's ``psum``).  ``torch.distributed.nn``'s differentiable
all-gather is not used: its backward sums every rank's gradient, which here
would multiply by D.  The appearance factors come from the replicated
parameters outside the slice, so their gradient is the same on every rank
and is not reduced.  The 2-D mesh (``parallel/mesh2d.py``) runs the same
step with a ``data`` axis over cameras.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from gsplat_tpu_torch.core import transforms as T
from gsplat_tpu_torch.device import check_on, resolve_device
from gsplat_tpu_torch.models import adam
from gsplat_tpu_torch.models.densify import add_densification_stats
from gsplat_tpu_torch.models.gaussians import GaussianParams
from gsplat_tpu_torch.ops.preprocess import TILE_Y
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from gsplat_tpu_torch.parallel import Axis, make_mesh, mesh_axis
from gsplat_tpu_torch.parallel.data_parallel import (MAX, SUM, DataReduce,
                                                     all_reduce_flat)
from gsplat_tpu_torch.train.trainer import gate_on_overflow, make_image_loss


def make_tile_mesh(n_devices: Optional[int] = None, device="cuda"):
    """A ``("tile",)`` mesh of ``n_devices`` ranks (default: the world)."""
    n = n_devices or dist.get_world_size()
    return make_mesh((n,), ("tile",), device)


def _slice_cfg(cfg_full: RasterizeConfig, D: int) -> RasterizeConfig:
    """The config of one of D row slices: whole tile rows per slice."""
    H = cfg_full.height
    if H % (TILE_Y * D):
        raise ValueError(f"height {H} does not split into whole "
                         f"{TILE_Y}-px tile rows over {D} slices")
    return replace(cfg_full, height=H // D, full_width=cfg_full.width,
                   full_height=H)


def render_slice(cfg_full: RasterizeConfig, D: int, index: int, means3d,
                 scales, rotations, opacities, shs, camera: dict, bg,
                 segments=None, means2d_offset=None, device="cuda"):
    """Rasterize row slice ``index`` of ``D`` of the full camera (the
    ``camera_batch`` or ``slice_camera`` dict): ``rasterize``'s output at
    ``[H/D, W]``.  The per-rank function of the tile module; the slices of
    ``index = 0 .. D-1`` concatenated along the rows are the full
    render."""
    cfg = _slice_cfg(cfg_full, D)
    return rasterize(cfg, means3d, scales, rotations, opacities, shs,
                     viewmatrix=camera["viewmatrix"],
                     projmatrix=camera["projmatrix"],
                     campos=camera["campos"], tan_fovx=camera["tan_fovx"],
                     tan_fovy=camera["tan_fovy"], bg=bg, segments=segments,
                     means2d_offset=means2d_offset,
                     pixel_offset=(0.0, float(index * cfg.height)),
                     device=device)


def gather_rows(x: torch.Tensor, tile: Axis) -> torch.Tensor:
    """The full image of every rank's row slice ``[..., H/D, W]`` (no
    autograd)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(tile.size)]
    dist.all_gather(parts, x, group=tile.group)
    return torch.cat(parts, dim=-2)


def _max_over(axis: Axis, *xs):
    """Elementwise maxima over the axis of integer or bool tensors, each
    returned in its own dtype."""
    red = all_reduce_flat([x.to(torch.int64).reshape(-1) for x in xs], MAX,
                          axis)
    return [r.view(x.shape).to(x.dtype) for r, x in zip(red, xs)]


def make_tile_sharded_render(mesh, cfg_full: RasterizeConfig, device="cuda"):
    """Returns ``render(means3d, scales, rotations, opacities, shs, camera,
    bg)`` -> the dict of the full ``[3, H, W]`` render, depth and alpha
    (gathered on every rank), radii, visibility and overflow (maxima over
    the slices); bit-equal to the single-device render."""
    tile = mesh_axis(mesh, "tile")
    dev = resolve_device(device)

    def render_full(means3d, scales, rotations, opacities, shs, camera, bg):
        out = render_slice(cfg_full, tile.size, tile.index, means3d, scales,
                           rotations, opacities, shs, camera, bg,
                           device=dev)
        radii, vis, overflow = _max_over(tile, out["radii"],
                                         out["visibility"], out["overflow"])
        return {"render": gather_rows(out["render"], tile),
                "depth": gather_rows(out["depth"], tile),
                "alpha": gather_rows(out["alpha"], tile),
                "radii": radii, "visibility": vis, "overflow": overflow}

    return render_full


def slice_camera(cam, n_devices: int, device="cuda") -> dict:
    """The camera dict of tile-sharded rendering: the plain full camera
    (the slicing is the pixel offset of each rank)."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)

    return {"viewmatrix": f32(cam.world_view_transform),
            "projmatrix": f32(cam.full_proj_transform),
            "campos": f32(cam.camera_center),
            "tan_fovx": float(cam.tan_fovx), "tan_fovy": float(cam.tan_fovy)}


def make_sliced_step(data: Optional[Axis], tile: Axis,
                     cfg_full: RasterizeConfig, opt, depth_loss_choice,
                     use_seg: bool, bg, track_stats: bool,
                     use_appearance: bool, app_lr: float, device):
    """The step of one camera's row slice: ``step(params, opt_state, aux,
    app, batch, lrs, generator, draws)`` with ``app`` ``()`` or, with
    ``use_appearance``, ``(app_params, app_opt_state)``.  The tile partials
    of the gradients are summed over ``tile``; with a ``data`` axis (the
    2-D mesh, one camera per data coordinate) the camera's gradients,
    statistics and metrics are then reduced over the cameras as the
    data-parallel step reduces them (``DataReduce``), which is the JAX 2-D
    step's mean loss with the means2d gradient per camera and the
    embedding's gradient times M."""
    dev = resolve_device(device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    H, W = cfg_full.height, cfg_full.width
    hs = H // tile.size
    rows = slice(tile.index * hs, (tile.index + 1) * hs)
    _slice_cfg(cfg_full, tile.size)       # refuses a height that won't split
    use_depth = depth_loss_choice is not None
    use_seg = use_seg and cfg_full.num_class > 0
    image_loss = make_image_loss(opt, depth_loss_choice, use_seg,
                                 cfg_full.num_class, dev)
    scale = torch.tensor([0.5 * W, 0.5 * H], dtype=torch.float32,
                         device=dev)
    reduce = (DataReduce(data, app=use_appearance) if data is not None
              else None)

    def step(params, opt_state, aux, app, batch, lrs, generator, draws):
        check_on(dev, xyz=params.xyz, emb=app[0].emb if app else None)
        old = (params, opt_state, aux, *app)
        P = params.xyz.shape[0]
        leaves = GaussianParams(
            *[p.detach().requires_grad_(True) for p in params])
        app_leaves = (type(app[0])(
            *[p.detach().requires_grad_(True) for p in app[0]])
            if app else ())
        m2d_off = torch.zeros((P, 2), dtype=torch.float32, device=dev,
                              requires_grad=True)
        out = render_slice(
            cfg_full, tile.size, tile.index, leaves.xyz,
            T.scaling_activation(leaves.scaling), leaves.rotation,
            T.opacity_activation(leaves.opacity[:, 0]),
            torch.cat([leaves.features_dc, leaves.features_rest], dim=1),
            batch, bg,
            segments=(T.segment_activation(leaves.segment)
                      if cfg_full.num_class > 0 else None),
            means2d_offset=m2d_off, device=dev)

        # the full image's loss on every rank, from gathered leaves
        planes = [out["render"]]
        planes += [out["depth"]] if use_depth else []
        planes += [out["segment"]] if use_seg else []
        full = [gather_rows(x, tile).requires_grad_(True) for x in planes]
        image = full[0]
        if app:
            from gsplat_tpu_torch.models import appearance as app_lib
            image = image * app_lib.apply(app_leaves, batch["uid"],
                                          batch["viewmatrix"]).reshape(
                                              3, 1, 1)
        loss, parts = image_loss(image, full[1] if use_depth else None,
                                 full[-1] if use_seg else None, batch,
                                 generator, draws)
        wrt_full = [*full, *app_leaves]
        g_full = [torch.zeros_like(x) if g is None else g
                  for g, x in zip(torch.autograd.grad(
                      loss, wrt_full, allow_unused=True), wrt_full)]

        # this rank's rows back through its slice, summed over the slices
        wrt = [*leaves, m2d_off]
        g_slice = torch.autograd.grad(
            planes, wrt, grad_outputs=[g[..., rows, :].contiguous()
                                       for g in g_full[:len(full)]],
            allow_unused=True)
        grads = all_reduce_flat([torch.zeros_like(x) if g is None else g
                                 for g, x in zip(g_slice, wrt)], SUM, tile)
        radii, vis, overflow, counts = _max_over(
            tile, out["radii"], out["visibility"], out["overflow"],
            torch.stack([out["num_rendered"].to(torch.int64),
                         out["num_padded"].to(torch.int64)]))
        grads += g_full[len(full):]
        n = len(leaves)
        if reduce is not None:
            grads = reduce.grads(grads, n)
        gparams, g_m2d = GaussianParams(*grads[:n]), grads[n]
        if track_stats:
            aux = (add_densification_stats if reduce is None
                   else reduce.stats)(aux, g_m2d * scale[None, :], radii)

        lrs_tree = GaussianParams(**{k: lrs[k]
                                     for k in GaussianParams._fields})
        new = (*adam.update(gparams, opt_state, params, lrs_tree), aux)
        if app:
            app_params, app_opt_state = app
            new += adam.update(type(app_params)(*grads[n + 1:]),
                               app_opt_state, app_params,
                               tuple(app_lr for _ in app_params))
        metrics = {
            "loss": loss.detach(), "l1": parts["l1"].detach(),
            "depth_loss": parts["depth_loss"].detach(),
            "seg_loss": parts["seg_loss"].detach(),
            "overflow": overflow, "num_rendered": counts[0],
            "num_padded": counts[1], "n_visible": torch.sum(vis),
        }
        if reduce is not None:
            metrics = reduce.metrics(metrics)
        return (*gate_on_overflow(metrics["overflow"], new, old), metrics)

    return step


def make_tile_sharded_train_step(mesh, cfg_full: RasterizeConfig, opt,
                                 sh_degree: int, depth_loss_choice,
                                 use_seg: bool, bg,
                                 use_appearance: bool = False,
                                 app_lr: float = 1e-4, device="cuda"):
    """A train step for one camera sharded by tile rows over ``mesh``'s
    ``tile`` axis, gradient-equal to the single-device full-image step.
    Returns ``(step, image_loss)`` as the JAX function returns ``(step,
    loss_fn)``: ``step(params, opt_state, aux, batch, lrs, generator=None,
    draws=None)`` with the plain camera batch, or with ``use_appearance``
    ``step(params, opt_state, aux, app_params, app_opt_state, batch, lrs,
    generator=None, draws=None)``; ``image_loss`` is the full-image loss
    every rank takes (``trainer.make_image_loss``).  ``generator`` or
    ``draws`` must be the same on every rank of the tile group."""
    body = make_sliced_step(None, mesh_axis(mesh, "tile"), cfg_full, opt,
                            depth_loss_choice, use_seg, bg, True,
                            use_appearance, app_lr, device)
    image_loss = make_image_loss(opt, depth_loss_choice, use_seg,
                                 cfg_full.num_class, resolve_device(device))
    if use_appearance:
        def app_step(params, opt_state, aux, app_params, app_opt_state,
                     batch, lrs, generator=None, draws=None):
            return body(params, opt_state, aux, (app_params, app_opt_state),
                        batch, lrs, generator, draws)
        return app_step, image_loss

    def step(params, opt_state, aux, batch, lrs, generator=None, draws=None):
        return body(params, opt_state, aux, (), batch, lrs, generator, draws)

    return step, image_loss

