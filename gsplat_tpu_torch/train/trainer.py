"""Training step (PyTorch port of ``gsplat_tpu/train/trainer.py``:
``camera_batch``, ``make_loss_fn``, ``gate_on_overflow``,
``make_train_step``).

Behavioral spec: reference train.py:33-216 / train_segment.py (loss mix,
densification statistics).  One step is one function over fixed-shape state:
render through ``ops.rasterize`` (kernels K3 and K1), losses, one
``torch.autograd.grad`` (kernels K2 and K4), densification statistics, Adam,
and the overflow gate.  The step returns new state tensors and leaves the
ones it was given as they were; it never reads a value back to the host, so
the overflow gate is a ``torch.where`` per state tensor, as in the JAX
package.  The ``Trainer`` loop, the appearance step and the pose optimizer
come with later slices.
"""
from __future__ import annotations

from typing import Optional

import torch

from gsplat_tpu_torch.core import transforms as T
from gsplat_tpu_torch.device import check_on, resolve_device
from gsplat_tpu_torch.models import adam
from gsplat_tpu_torch.models.densify import add_densification_stats
from gsplat_tpu_torch.models.gaussians import GaussianParams
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from gsplat_tpu_torch.train import losses as L


def camera_batch(cam, gt_depth=None, gt_seg=None, device="cuda"):
    """The per-camera tensors of a train step, on ``device``."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    H, W = int(cam.image_height), int(cam.image_width)
    depth = gt_depth if gt_depth is not None else getattr(cam, "depth", None)
    seg = gt_seg if gt_seg is not None else getattr(cam, "segment", None)
    return {
        "uid": torch.tensor(int(getattr(cam, "uid", 0)), dtype=torch.int32,
                            device=dev),
        "viewmatrix": f32(cam.world_view_transform),
        "projmatrix": f32(cam.full_proj_transform),
        "campos": f32(cam.camera_center),
        "tan_fovx": float(cam.tan_fovx),
        "tan_fovy": float(cam.tan_fovy),
        "gt_image": f32(cam.image),
        "gt_depth": (f32(depth) if depth is not None
                     else torch.zeros((1, H, W), device=dev)),
        "has_depth": torch.tensor(depth is not None, device=dev),
        "gt_seg": (torch.as_tensor(seg, device=dev).to(torch.int32)
                   if seg is not None
                   else torch.zeros((H, W), dtype=torch.int32, device=dev)),
        "has_seg": torch.tensor(seg is not None, device=dev),
    }


def make_loss_fn(cfg: RasterizeConfig, opt, sh_degree: int,
                 depth_loss_choice: Optional[str], use_seg: bool, bg,
                 convert_shs_python: bool = False,
                 compute_cov3d_python: bool = False, device="cuda"):
    """Loss on raw params for one camera.  Mirrors train.py:110-141 +
    train_segment.py:125-138.  ``convert_shs_python`` /
    ``compute_cov3d_python`` route SH->RGB and the 3D covariance through the
    module-level functions as precomputed rasterizer inputs (reference pipe
    flags, gaussian_renderer/__init__.py:341-359); both are differentiable,
    so gradients still flow."""
    dev = resolve_device(device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)

    def loss_fn(params: GaussianParams, m2d_off, batch, generator=None,
                draws=None):
        colors_precomp = None
        if convert_shs_python:
            from gsplat_tpu_torch.core import sh as sh_lib
            colors_precomp = sh_lib.sh_to_rgb(
                sh_degree,
                torch.cat([params.features_dc, params.features_rest], dim=1),
                params.xyz, batch["campos"])
        cov3d_precomp = None
        if compute_cov3d_python:
            cov3d_precomp = T.covariance_from_scaling_rotation(
                T.scaling_activation(params.scaling), 1.0, params.rotation)
        out = rasterize(
            cfg,
            params.xyz,
            T.scaling_activation(params.scaling),
            params.rotation,
            T.opacity_activation(params.opacity[:, 0]),
            torch.cat([params.features_dc, params.features_rest], dim=1),
            viewmatrix=batch["viewmatrix"],
            projmatrix=batch["projmatrix"],
            campos=batch["campos"],
            tan_fovx=batch["tan_fovx"],
            tan_fovy=batch["tan_fovy"],
            bg=bg,
            segments=(T.segment_activation(params.segment)
                      if cfg.num_class > 0 else None),
            means2d_offset=m2d_off,
            colors_precomp=colors_precomp,
            cov3d_precomp=cov3d_precomp,
            device=dev,
        )
        image = out["render"]
        gt = batch["gt_image"]
        l1 = L.l1_loss(image, gt)
        loss = ((1.0 - opt.lambda_dssim) * l1
                + opt.lambda_dssim * (1.0 - L.ssim(image, gt)))

        zero = torch.zeros((), dtype=torch.float32, device=dev)
        depth_loss = zero
        if depth_loss_choice is not None:
            # reference normalizes depth by its max before the inverse-depth
            # losses (gaussian_renderer/__init__.py:375 + train.py:114-141)
            depth = out["depth"] / (torch.max(out["depth"]) + 1e-5)
            dl = L.depth_loss_dispatch(depth_loss_choice, depth,
                                       batch["gt_depth"], opt,
                                       generator=generator, draws=draws)
            depth_loss = torch.where(batch["has_depth"], dl, 0.0)
            loss = loss + depth_loss

        seg_loss = zero
        if use_seg and cfg.num_class > 0:
            sl = L.segment_loss(out["segment"], batch["gt_seg"]) \
                * opt.lambda_segment
            seg_loss = torch.where(batch["has_seg"], sl, 0.0)
            loss = loss + seg_loss

        auxout = {
            "l1": l1, "depth_loss": depth_loss, "seg_loss": seg_loss,
            "radii": out["radii"], "visibility": out["visibility"],
            "overflow": out["overflow"], "num_rendered": out["num_rendered"],
            "num_padded": out["num_padded"],
            "render": image,
        }
        return loss, auxout

    return loss_fn


def gate_on_overflow(pred, new_tree, old_tree):
    """An instance-capacity-overflow step renders with DROPPED instances:
    its gradients are garbage.  Keep every state tensor at the pre-step
    value when ``pred`` (the rasterizer's overflow flag, a 0-d bool tensor)
    is set; the metrics still report the overflow so the host regrows
    capacity and the skipped step costs one iteration, not the model."""
    return adam.tree_map(lambda n, o: torch.where(pred, o, n), new_tree,
                         old_tree)


def make_train_step(cfg: RasterizeConfig, opt, sh_degree: int,
                    depth_loss_choice: Optional[str], use_seg: bool, bg,
                    track_stats: bool = True,
                    convert_shs_python: bool = False,
                    compute_cov3d_python: bool = False, device="cuda"):
    """Returns ``step(params, opt_state, aux, batch, lrs, generator=None,
    draws=None) -> (params, opt_state, aux, metrics)``.  ``lrs`` is the dict
    of per-group learning rates (``schedules.make_lr_fn``); ``generator``
    feeds the random depth losses, and ``draws`` hands them fixed numbers
    instead (``losses.depth_loss_dispatch``)."""
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg, opt, sh_degree, depth_loss_choice, use_seg,
                           bg, convert_shs_python=convert_shs_python,
                           compute_cov3d_python=compute_cov3d_python,
                           device=dev)
    scale = torch.tensor([0.5 * cfg.width, 0.5 * cfg.height],
                         dtype=torch.float32, device=dev)

    def step(params, opt_state, aux, batch, lrs, generator=None, draws=None):
        check_on(dev, xyz=params.xyz)
        old = (params, opt_state, aux)
        P = params.xyz.shape[0]
        leaves = GaussianParams(
            *[p.detach().requires_grad_(True) for p in params])
        m2d_off = torch.zeros((P, 2), dtype=torch.float32, device=dev,
                              requires_grad=True)
        loss, auxout = loss_fn(leaves, m2d_off, batch, generator, draws)
        grads = torch.autograd.grad(loss, [*leaves, m2d_off],
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, [*leaves, m2d_off])]
        gparams, g_m2d = GaussianParams(*grads[:-1]), grads[-1]

        # densification stats: NDC-scaled mean2d grad norm
        # (backward.cu:627-628; add_densification_stats gaussian_model.py:523)
        if track_stats:
            aux = add_densification_stats(aux, g_m2d * scale[None, :],
                                          auxout["radii"])

        lrs_tree = GaussianParams(**{k: lrs[k]
                                     for k in GaussianParams._fields})
        params, opt_state = adam.update(gparams, opt_state, params, lrs_tree)
        params, opt_state, aux = gate_on_overflow(
            auxout["overflow"], (params, opt_state, aux), old)
        metrics = {
            "loss": loss.detach(), "l1": auxout["l1"].detach(),
            "depth_loss": auxout["depth_loss"].detach(),
            "seg_loss": auxout["seg_loss"].detach(),
            "overflow": auxout["overflow"],
            "num_rendered": auxout["num_rendered"],
            "num_padded": auxout["num_padded"],
            "n_visible": torch.sum(auxout["visibility"]),
        }
        return params, opt_state, aux, metrics

    return step
