"""Training step and loop (PyTorch port of ``gsplat_tpu/train/trainer.py``:
``camera_batch``, ``make_loss_fn``, ``gate_on_overflow``,
``make_appearance_step``, ``make_train_step``, ``Trainer``).

Behavioral spec: reference train.py:33-216 / train_segment.py (loss mix,
densification schedule, opacity resets, checkpointing).  One step is one
function over fixed-shape state: render through ``ops.rasterize`` (kernel
K3, and under ``cull="exact"`` its extras form, then K1), losses, one
``torch.autograd.grad`` (kernels K2 and K4), densification statistics, Adam,
and the overflow gate.  The step returns new state tensors and leaves the
ones it was given as they were; it never reads a value back to the host, so
the overflow gate is a ``torch.where`` per state tensor, as in the JAX
package.  ``make_appearance_step`` is the same step with the per-camera
appearance embedding (``models/appearance.py``) trained beside the
gaussians.  ``Trainer`` is the host loop around them, on one device or, one
process per device, over the meshes of ``parallel/``, with the live-viewer
socket polled at the top of each iteration (``viz/network_gui.py``).
"""
from __future__ import annotations

import json
import os
import time
from collections import OrderedDict, deque
from typing import Optional

import numpy as np
import torch

from gsplat_tpu_torch import tracing
from gsplat_tpu_torch.core import transforms as T
from gsplat_tpu_torch.device import check_on, resolve_device
from gsplat_tpu_torch.models import adam
from gsplat_tpu_torch.models.densify import (add_densification_stats,
                                             densify_and_prune, reset_opacity)
from gsplat_tpu_torch.models.gaussians import GaussianModel, GaussianParams
from gsplat_tpu_torch.ops import preprocess as pre_lib
from gsplat_tpu_torch.ops.rasterize import (BACKENDS, RasterizeConfig,
                                            rasterize)
from gsplat_tpu_torch.train import losses as L
from gsplat_tpu_torch.train.schedules import make_lr_fn


def camera_batch(cam, gt_depth=None, gt_seg=None, device="cuda"):
    """The per-camera tensors of a train step, on ``device``."""
    dev = resolve_device(device)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    if gt_depth is None and gt_seg is None and hasattr(cam, "_pixels"):
        # LazyCamera: one decode for all three planes (each property access
        # would decode the file again)
        image, gt_depth, gt_seg = cam._pixels()
    else:
        image = cam.image
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
        "gt_image": f32(image),
        "gt_depth": (f32(depth) if depth is not None
                     else torch.zeros((1, H, W), device=dev)),
        "has_depth": torch.tensor(depth is not None, device=dev),
        "gt_seg": (torch.as_tensor(seg, device=dev).to(torch.int32)
                   if seg is not None
                   else torch.zeros((H, W), dtype=torch.int32, device=dev)),
        "has_seg": torch.tensor(seg is not None, device=dev),
    }


def make_image_loss(opt, depth_loss_choice: Optional[str], use_seg: bool,
                    num_class: int, device):
    """The loss of one camera's rendered planes: ``image_loss(image [3,H,W],
    depth [H,W], segment [S,H,W] or None, batch, generator, draws) ->
    (loss, {"l1", "depth_loss", "seg_loss"})``.  The single-device loss and
    the tile-sharded steps (``parallel/tile_parallel.py``, which take it on
    the gathered full image) share it."""
    def image_loss(image, depth, segment, batch, generator=None, draws=None):
        with tracing.span("step.losses"):
            gt = batch["gt_image"]
            l1 = L.l1_loss(image, gt)
            loss = ((1.0 - opt.lambda_dssim) * l1
                    + opt.lambda_dssim * (1.0 - L.ssim(image, gt)))

            zero = torch.zeros((), dtype=torch.float32, device=device)
            depth_loss = zero
            if depth_loss_choice is not None:
                # reference normalizes depth by its max before the
                # inverse-depth losses (gaussian_renderer/__init__.py:375 +
                # train.py:114-141)
                depth = depth / (torch.max(depth) + 1e-5)
                dl = L.depth_loss_dispatch(depth_loss_choice, depth,
                                           batch["gt_depth"], opt,
                                           generator=generator, draws=draws)
                depth_loss = torch.where(batch["has_depth"], dl, 0.0)
                loss = loss + depth_loss

            seg_loss = zero
            if use_seg and num_class > 0:
                sl = (L.segment_loss(segment, batch["gt_seg"])
                      * opt.lambda_segment)
                seg_loss = torch.where(batch["has_seg"], sl, 0.0)
                loss = loss + seg_loss
            return loss, {"l1": l1, "depth_loss": depth_loss,
                          "seg_loss": seg_loss}

    return image_loss


def make_loss_fn(cfg: RasterizeConfig, opt, sh_degree: int,
                 depth_loss_choice: Optional[str], use_seg: bool, bg,
                 convert_shs_python: bool = False,
                 compute_cov3d_python: bool = False, device="cuda"):
    """Loss on raw params for one camera.  Mirrors train.py:110-141 +
    train_segment.py:125-138 (+ the appearance factors, train.py:100-104,
    when the loss is given ``app_params``; the JAX function also takes a
    ``use_appearance`` flag, which ``app_params`` alone decides here).
    ``convert_shs_python`` /
    ``compute_cov3d_python`` route SH->RGB and the 3D covariance through the
    module-level functions as precomputed rasterizer inputs (reference pipe
    flags, gaussian_renderer/__init__.py:341-359); both are differentiable,
    so gradients still flow."""
    dev = resolve_device(device)
    bg = torch.as_tensor(bg, dtype=torch.float32, device=dev)
    image_loss = make_image_loss(opt, depth_loss_choice, use_seg,
                                 cfg.num_class, dev)

    def loss_fn(params: GaussianParams, m2d_off, batch, generator=None,
                draws=None, app_params=None):
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
        if app_params is not None:
            from gsplat_tpu_torch.models import appearance as app_lib
            factors = app_lib.apply(app_params, batch["uid"],
                                    batch["viewmatrix"])
            image = image * factors.reshape(3, 1, 1)
        loss, parts = image_loss(image, out["depth"], out.get("segment"),
                                 batch, generator, draws)
        auxout = {
            **parts,
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


def _make_step(cfg: RasterizeConfig, opt, sh_degree: int,
               depth_loss_choice: Optional[str], use_seg: bool, bg,
               track_stats: bool, app_lr: float, convert_shs_python: bool,
               compute_cov3d_python: bool, device, reduce=None):
    """The step body ``make_train_step``, ``make_appearance_step`` and the
    data-parallel steps (``parallel/data_parallel.py``) share:
    ``step(params, opt_state, aux, app, batch, lrs, generator, draws)``,
    where ``app`` is ``()`` or ``(app_params, app_opt_state)``.  One
    ``torch.autograd.grad`` over the gaussian parameters, the screen-space
    offsets and the appearance parameters; the appearance's own Adam update
    at ``app_lr`` with its own step count; the overflow gate over every
    state tree.

    ``reduce`` is the reduction hook across devices: ``reduce.grads(grads,
    n)`` between the gradient and Adam (``n`` gaussian fields, then the
    offsets' gradient, then the appearance's), ``reduce.stats`` in place of
    ``add_densification_stats``, and ``reduce.metrics`` before the gate,
    which reads the reduced overflow.  ``None``, the single device, runs
    none of them.

    The step's spans (``tracing.py``) partition it: ``step.forward`` (the
    loss, with ``rasterize.*`` and ``step.losses`` inside), ``step.backward``
    (the gradient and ``reduce.grads``) and ``step.update``."""
    dev = resolve_device(device)
    loss_fn = make_loss_fn(cfg, opt, sh_degree, depth_loss_choice, use_seg,
                           bg, convert_shs_python=convert_shs_python,
                           compute_cov3d_python=compute_cov3d_python,
                           device=dev)
    scale = torch.tensor([0.5 * cfg.width, 0.5 * cfg.height],
                         dtype=torch.float32, device=dev)

    def step(params, opt_state, aux, app, batch, lrs, generator, draws):
        check_on(dev, xyz=params.xyz, emb=app[0].emb if app else None)
        old = (params, opt_state, aux, *app)
        with tracing.span("step.forward"):
            P = params.xyz.shape[0]
            leaves = GaussianParams(
                *[p.detach().requires_grad_(True) for p in params])
            app_leaves = (type(app[0])(
                *[p.detach().requires_grad_(True) for p in app[0]])
                if app else None)
            m2d_off = torch.zeros((P, 2), dtype=torch.float32, device=dev,
                                  requires_grad=True)
            loss, auxout = loss_fn(leaves, m2d_off, batch, generator, draws,
                                   app_params=app_leaves)
        with tracing.span("step.backward"):
            wrt = [*leaves, m2d_off, *(app_leaves or ())]
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(torch.autograd.grad(
                         loss, wrt, allow_unused=True), wrt)]
            n = len(leaves)
            if reduce is not None:
                grads = reduce.grads(grads, n)
        with tracing.span("step.update"):
            gparams, g_m2d = GaussianParams(*grads[:n]), grads[n]

            # densification stats: NDC-scaled mean2d grad norm
            # (backward.cu:627-628; add_densification_stats
            # gaussian_model.py:523)
            if track_stats:
                aux = (add_densification_stats if reduce is None
                       else reduce.stats)(aux, g_m2d * scale[None, :],
                                          auxout["radii"])

            lrs_tree = GaussianParams(**{k: lrs[k]
                                         for k in GaussianParams._fields})
            new = (*adam.update(gparams, opt_state, params, lrs_tree), aux)
            if app:
                app_params, app_opt_state = app
                new += adam.update(type(app_params)(*grads[n + 1:]),
                                   app_opt_state, app_params,
                                   tuple(app_lr for _ in app_params))
            metrics = {
                "loss": loss.detach(), "l1": auxout["l1"].detach(),
                "depth_loss": auxout["depth_loss"].detach(),
                "seg_loss": auxout["seg_loss"].detach(),
                "overflow": auxout["overflow"],
                "num_rendered": auxout["num_rendered"],
                "num_padded": auxout["num_padded"],
                "n_visible": torch.sum(auxout["visibility"]),
            }
            if reduce is not None:
                metrics = reduce.metrics(metrics)
            return (*gate_on_overflow(metrics["overflow"], new, old), metrics)

    return step


def make_appearance_step(cfg: RasterizeConfig, opt, sh_degree: int,
                         depth_loss_choice: Optional[str], use_seg: bool, bg,
                         app_lr: float = 1e-4,
                         convert_shs_python: bool = False,
                         compute_cov3d_python: bool = False, device="cuda"):
    """The train step that also optimizes the appearance embedding
    (reference train.py:100-104,188-190).  Returns ``step(params,
    opt_state, aux, app_params, app_opt_state, batch, lrs, generator=None,
    draws=None) -> (params, opt_state, aux, app_params, app_opt_state,
    metrics)`` (``_make_step``)."""
    body = _make_step(cfg, opt, sh_degree, depth_loss_choice, use_seg, bg,
                      True, app_lr, convert_shs_python, compute_cov3d_python,
                      device)

    def step(params, opt_state, aux, app_params, app_opt_state, batch, lrs,
             generator=None, draws=None):
        return body(params, opt_state, aux, (app_params, app_opt_state),
                    batch, lrs, generator, draws)

    return step


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
    body = _make_step(cfg, opt, sh_degree, depth_loss_choice, use_seg, bg,
                      track_stats, 0.0, convert_shs_python,
                      compute_cov3d_python, device)

    def step(params, opt_state, aux, batch, lrs, generator=None, draws=None):
        return body(params, opt_state, aux, (), batch, lrs, generator, draws)

    return step


def _end_trace(was_on: bool):
    """Puts tracing back as a profiler window found it, dropping the
    window's span records if nothing had turned tracing on."""
    tracing.on(was_on)
    if not was_on:
        tracing.take()


class Trainer:
    """Host-side loop: mirrors train.py's schedule (densify every 100 its
    between 500 and 15k, opacity reset every 3k, SH degree up every 1k), on
    the model's device, one rank of a mesh or the only one.

    What differs from the JAX ``Trainer``:
    - PyTorch compiles nothing, so the JAX package's compile-ahead machinery
      (``_pending``, ``_precompile_async``, ``_try_adopt_pending``,
      ``_pending_inflight_covers``) has no counterpart: a capacity change
      takes effect at once, which is what the JAX loop does when no
      background compile is ready.  ``_manage_capacity`` keeps its
      thresholds (grow above 90% of the capacity or on overflow, twice the
      capacity at least on overflow; shrink below 50% after a 200-iteration
      cooldown and 500 iterations after an opacity reset).
    - The JAX keys become one ``torch.Generator`` on the model's device,
      seeded from ``seed``; it feeds the random depth losses and the split
      samples of densification.  Its streams differ from JAX's.
    - ``profile_dir`` records a ``torch.profiler`` trace (Chrome format)
      with the port's spans in it.
    - The appearance embedding's initial weights come from a
      ``torch.Generator`` seeded 1337 (``models/appearance.py``), not from
      JAX's key.
    - Multi-device training is one process per device (``parallel/``):
      ``data_parallel`` and ``tile_parallel`` build their mesh over the
      ranks of the ``torch.distributed`` group, ``data_parallel`` -1 or
      above the ranks there are taking them all.  Every rank runs this loop
      on the replicated state: densify, prune, the opacity reset and the
      capacity checks (on reduced metrics) run on every rank from the same
      state and the same seeded generator, so the ranks stay bit-identical.
      Each data rank draws its depth losses from a generator of its own
      (seeded ``seed + 1 + its data coordinate``, the same on every rank
      of a tile group; JAX folds the device index into its key); a
      tile-sharded run draws from the one generator, the same on every
      rank.  Only rank 0 writes files (PLY, checkpoints,
      the evaluation log and its renders, the profiler trace) and polls the
      viewer socket; the STOP file ends every rank at the same iteration.

    As in the JAX ``Trainer``, ``grad_precision`` and ``feat_precision``
    default to ``"bf16"`` (per-instance gradient rows rounded to bf16
    before the f32 per-gaussian sum; the features packed as bf16 pairs;
    ``"f32"`` for bitwise-grade gradient parity runs) and every step is
    built with ``mxu_power=True``.
    """

    def __init__(self, model: GaussianModel, scene, opt, *, bg=None,
                 depth_loss_choice=None, use_seg=False, backend="auto",
                 max_instances=0, seed=0, model_path=None,
                 gui_source_path=None, grad_precision="bf16", cull="none",
                 data_parallel=1, use_appearance=False, tile_parallel=1,
                 gt_cache=0, feat_precision="bf16",
                 convert_shs_python=False, compute_cov3d_python=False,
                 debug_from=-1, vs_prune=False, white_background=False):
        for name, value in (("grad_precision", grad_precision),
                            ("feat_precision", feat_precision)):
            if value not in ("f32", "bf16"):
                raise ValueError(f"{name} must be 'f32' or 'bf16', got "
                                 f"{value!r}")
        if backend not in BACKENDS:
            raise ValueError(f"backend={backend!r}: expected one of "
                             f"{BACKENDS}")
        if cull not in ("none", "exact"):
            raise ValueError(f"cull must be 'none' or 'exact', got {cull!r}")
        self.model = model
        self.scene = scene
        self.opt = opt
        self.device = model.device
        self.use_seg = use_seg
        self.depth_loss_choice = depth_loss_choice
        self.backend = backend
        self.model_path = model_path
        # pipe.convert_SHs_python / pipe.compute_cov3D_python: precomputed
        # rasterizer inputs (reference gaussian_renderer/__init__.py:341-359)
        self.convert_shs_python = convert_shs_python
        self.compute_cov3d_python = compute_cov3d_python
        # --debug_from: from this iteration on, check each step's loss is
        # finite and dump the step's inputs on failure (the reference's
        # pipe.debug snapshot); -1 = off
        self.debug_from = debug_from
        # vs_prune=True restores the screen-radius prune: an ablation arm
        # only (see models/densify.py::densify_and_prune)
        self.vs_prune = vs_prune
        # white_background triggers the reference's extra opacity reset at
        # densify_from_iter (train.py:178-180)
        self.white_background = white_background
        self.last_densify = None  # dict written after each densify call
        if (convert_shs_python or compute_cov3d_python) and (
                (data_parallel and data_parallel != 1) or tile_parallel > 1):
            # this guard must stay ahead of any parallel step factory: the
            # parallel steps do not take these flags
            raise ValueError("convert_SHs_python/compute_cov3D_python are "
                             "single-device debug backends")
        cams = scene.getTrainCameras()
        W, H = cams[0].image_width, cams[0].image_height
        self.appearance = None
        if use_appearance:
            # per-camera learned RGB factors optimized with the gaussians
            # (reference train.py:42-44,100-104,188-190)
            from gsplat_tpu_torch.models.appearance import AppearanceOptimizer
            n_uid = max((getattr(c, "uid", 0) for c in cams), default=0) + 1
            self.appearance = AppearanceOptimizer(max(n_uid, len(cams)),
                                                  device=self.device)
        P = model.capacity
        self._auto_capacity = max_instances <= 0
        if max_instances <= 0:
            # provisional until _autosize_capacity measures the real scene
            max_instances = max(1 << 18,
                                int(2 ** np.ceil(np.log2(max(P, 2) * 8))))
        self.max_instances = max_instances
        self.bg = torch.as_tensor(np.zeros(3) if bg is None else bg,
                                  dtype=torch.float32, device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._setup_parallel(data_parallel, tile_parallel, cams, W, H, seed)
        self.lr_fn = make_lr_fn(opt, model.spatial_lr_scale)
        self._steps = {}
        self._cfg = lambda sh, mi=None: RasterizeConfig(
            width=W, height=H, sh_degree=sh,
            num_class=model.num_class if use_seg else 0,
            max_instances=mi if mi else self.max_instances, backend=backend,
            grad_precision=grad_precision, cull=cull,
            feat_precision=feat_precision, mxu_power=True)
        self.ema_loss = 0.0
        self.gui_source_path = gui_source_path  # enables SIBR socket polling
        self._pending_checks = deque()   # (it, npad, nr, overflow, max_i)
        self._check_interval = 1         # adaptive (see train loop)
        self._resize_iter = -10**9       # shrink cooldown anchor
        self._reset_iter = -10**9        # last opacity reset (demand dip)
        # LRU cap on the per-camera device-batch cache: every cached batch
        # pins a camera's GT image (+depth/seg) in device memory.  0 = auto:
        # ~2 GB of GT batches.
        if gt_cache <= 0:
            planes = 3 + 2  # rgb + depth + seg (seg int32 counts as one)
            per_batch = planes * W * H * 4
            gt_cache = max(8, int(2e9 // max(per_batch, 1)))
        self._gt_cache = max(gt_cache, 2 * max(1, self.data_parallel))
        self._batches = OrderedDict()

    def _setup_parallel(self, data_parallel, tile_parallel, cams, W, H,
                        seed):
        """The mesh of a multi-device run (JAX ``Trainer.__init__``
        :317-362): ``data``, ``tile`` or both, over the ranks of the
        process group."""
        import torch.distributed as dist
        self.mesh = None
        self.data_parallel = 0
        self.tile_parallel = tile_parallel if tile_parallel > 1 else 0
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.step_generator = self.generator
        if self.tile_parallel and H % (pre_lib.TILE_Y
                                       * self.tile_parallel) != 0:
            raise ValueError(
                f"--tile_parallel {self.tile_parallel} needs the image "
                f"height ({H}) to split into whole {pre_lib.TILE_Y}-px tile "
                "rows per device")
        world = dist.get_world_size() if dist.is_initialized() else 1
        if data_parallel and data_parallel != 1:
            navail = world // max(1, self.tile_parallel)
            ndev = (navail if data_parallel < 0
                    else min(data_parallel, navail))
            if ndev > 1:
                bad = [c for c in cams
                       if (c.image_width, c.image_height) != (W, H)]
                if bad:
                    raise ValueError(
                        "--data_parallel requires a uniform camera "
                        f"resolution; got {len(bad)} cameras != {W}x{H}")
                from gsplat_tpu_torch.parallel import mesh_axis
                if self.tile_parallel:
                    from gsplat_tpu_torch.parallel.mesh2d import make_2d_mesh
                    self.mesh = make_2d_mesh(ndev, self.tile_parallel,
                                             self.device)
                else:
                    from gsplat_tpu_torch.parallel.data_parallel import (
                        make_data_mesh)
                    self.mesh = make_data_mesh(ndev, self.device)
                self.data_parallel = ndev
                # one camera per rank: the sampler gives every rank the same
                # global order and this rank its own camera of it
                self.proc_idx = mesh_axis(self.mesh, "data").index
                self._sampler = None
                self.step_generator = torch.Generator(device=self.device)
                self.step_generator.manual_seed(seed + 1 + self.proc_idx)
                print(f"[parallel] {ndev} camera(s) x "
                      f"{max(1, self.tile_parallel)} tile slice(s) per step "
                      f"over {ndev * max(1, self.tile_parallel)} ranks "
                      f"(rank {self.rank} of {world})")
        if self.tile_parallel and not self.data_parallel:
            from gsplat_tpu_torch.parallel.tile_parallel import make_tile_mesh
            self.mesh = make_tile_mesh(self.tile_parallel, self.device)
            print(f"[parallel] tile-sharded training over "
                  f"{self.tile_parallel} ranks (one camera per step, row "
                  f"slices; rank {self.rank} of {world})")

    def _build_step(self, sh_degree, max_instances):
        use_app = self.appearance is not None
        app_lr = self.appearance.lr if use_app else 1e-4
        cfg = self._cfg(sh_degree, max_instances)
        args = (self.mesh, cfg, self.opt, sh_degree, self.depth_loss_choice,
                self.use_seg, self.bg)
        if self.data_parallel and self.tile_parallel:
            from gsplat_tpu_torch.parallel.mesh2d import make_2d_train_step
            return make_2d_train_step(*args, use_appearance=use_app,
                                      app_lr=app_lr, device=self.device)
        if self.tile_parallel:
            from gsplat_tpu_torch.parallel.tile_parallel import (
                make_tile_sharded_train_step)
            return make_tile_sharded_train_step(
                *args, use_appearance=use_app, app_lr=app_lr,
                device=self.device)[0]
        if self.data_parallel:
            from gsplat_tpu_torch.parallel import data_parallel as dp
            if use_app:
                return dp.make_parallel_appearance_step(
                    *args, app_lr=app_lr, device=self.device)
            return dp.make_parallel_train_step(*args, device=self.device)
        if self.appearance is not None:
            return make_appearance_step(
                self._cfg(sh_degree, max_instances), self.opt, sh_degree,
                self.depth_loss_choice, self.use_seg, self.bg,
                app_lr=self.appearance.lr,
                convert_shs_python=self.convert_shs_python,
                compute_cov3d_python=self.compute_cov3d_python,
                device=self.device)
        return make_train_step(
            self._cfg(sh_degree, max_instances), self.opt, sh_degree,
            self.depth_loss_choice, self.use_seg, self.bg,
            convert_shs_python=self.convert_shs_python,
            compute_cov3d_python=self.compute_cov3d_python,
            device=self.device)

    def _step_fn(self, sh_degree):
        k = (sh_degree, self.model.capacity, self.max_instances)
        if k not in self._steps:
            self._steps[k] = self._build_step(sh_degree, self.max_instances)
        return self._steps[k]

    def _autosize_capacity(self, cams):
        """Measure the scene's real instance demand on a few cameras and
        size the fixed binning capacity snugly (1.35x + per-tile alignment
        pads) instead of the static P*8 guess: every binning, sort and
        gather cost scales with the capacity.  Rounded to 128k blocks."""
        cfg = self._cfg(self.model.max_sh_degree)
        p = self.model.params
        demands = []
        with torch.no_grad():
            for c in cams[: min(4, len(cams))]:
                b = camera_batch(c, device=self.device)
                pre = pre_lib.preprocess(
                    p.xyz, T.scaling_activation(p.scaling), p.rotation,
                    T.opacity_activation(p.opacity[:, 0]),
                    torch.cat([p.features_dc, p.features_rest], dim=1),
                    self.model.max_sh_degree, b["viewmatrix"],
                    b["projmatrix"], b["campos"], b["tan_fovx"],
                    b["tan_fovy"], cfg.width, cfg.height)
                rh = torch.clamp(pre.rect_max[:, 1] - pre.rect_min[:, 1],
                                 min=1)
                rows = torch.sum(torch.where(pre.visible, rh, 0))
                with tracing.sync(2):
                    demands.append((int(torch.sum(pre.tiles_touched)),
                                    int(rows)))
        nr = max(d[0] for d in demands)
        rows = max(d[1] for d in demands)
        pads = cfg.grid_x * cfg.grid_y * 64  # expected pad-inline overhead
        # the exact-cull row stage's capacity defaults to max_instances//2
        # (ops/binning.py::row_capacity); rows scale with TILE_Y only, so at
        # wide tiles instance demand shrinks while rows don't: size the
        # capacity to cover both (the overflow flag and the geometric regrow
        # still guard drift during densification)
        self._resize_capacity(max(int(nr * 1.35) + pads,
                                  2 * int(rows * 1.35)))

    def _resize_capacity(self, needed: int):
        blk = 1 << 17
        self.max_instances = max(1 << 18, (needed + blk - 1) // blk * blk)
        self._steps.clear()

    def train(self, iterations=None, *, test_iterations=(), save_iterations=(),
              checkpoint_iterations=(), log_every=10, callback=None,
              first_iter=0, profile_dir=None, profile_iters=(50, 80)):
        """``profile_dir``: record a ``torch.profiler`` trace (CPU and, on a
        card, CUDA activity) over iterations [profile_iters), with the
        port's spans on (``tracing.py``; ``gsplat.*`` ranges), and write it
        there as ``trace.json`` (Chrome trace format).  Returns the
        wall-clock seconds of the loop.

        Spans: ``iter`` (carrying the iteration) over ``iter.batch``,
        ``iter.step`` (the step's ``step.*`` spans), ``iter.capacity``,
        ``iter.log`` and ``iter.densify``; ``sync`` around every readback
        (counted in ``host_syncs``)."""
        opt = self.opt
        iterations = iterations or opt.iterations
        m = self.model
        cams = list(self.scene.getTrainCameras())
        if self._auto_capacity:
            self._autosize_capacity(cams)
            self._auto_capacity = False
            print(f"[capacity] instance capacity sized to "
                  f"{self.max_instances} from measured scene demand")
        stack = []
        rng = np.random.default_rng(0)
        prof = None

        t_start = time.time()
        traced = False   # whether tracing was on before the profiler window
        for it in range(first_iter + 1, iterations + 1):
            if (profile_dir and self.rank == 0
                    and it - first_iter == profile_iters[0]):
                acts = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
                # the port's spans show in the trace as gsplat.* ranges
                traced = tracing.on()
            if prof is not None and it - first_iter == profile_iters[1]:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                prof.stop()
                _end_trace(traced)
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(profile_dir, "trace.json"))
                prof = None
                print(f"[it {it}] profiler trace written to {profile_dir}")
            with tracing.span("iter", it):
                # live-viewer poll (reference train.py:71-84)
                if self.gui_source_path is not None and self.rank == 0:
                    self._poll_gui()
                if it % 1000 == 0:
                    m.oneup_sh_degree()
                with tracing.span("iter.batch"):
                    if self.data_parallel:
                        from gsplat_tpu_torch.parallel.data_parallel import (
                            stack_camera_batches)
                        from gsplat_tpu_torch.parallel.multihost import (
                            ShardedCameraSampler)
                        if self._sampler is None:
                            self._sampler = ShardedCameraSampler(
                                len(cams), 1, self.proc_idx,
                                self.data_parallel, seed=0)
                        batch = stack_camera_batches(
                            [self._get_batch(cams, i)
                             for i in self._sampler.sample()])
                    else:
                        if not stack:
                            stack = list(range(len(cams)))
                        cam_idx = stack.pop(rng.integers(0, len(stack)))
                        batch = self._get_batch(cams, cam_idx)

                with tracing.span("iter.step"):
                    lrs = self.lr_fn(it)
                    step = self._step_fn(m.active_sh_degree)
                    if self.appearance is not None:
                        app = self.appearance
                        (m.params, m.opt_state, m.aux, app.params,
                         app.opt_state, metrics) = step(
                            m.params, m.opt_state, m.aux, app.params,
                            app.opt_state, batch, lrs,
                            generator=self.step_generator)
                    else:
                        m.params, m.opt_state, m.aux, metrics = step(
                            m.params, m.opt_state, m.aux, batch, lrs,
                            generator=self.step_generator)
                if 0 <= self.debug_from <= it:
                    # reference pipe.debug from --debug_from: a per-step
                    # finite check (one device sync), and the step's inputs
                    # dumped on failure
                    with tracing.sync():
                        loss_now = float(metrics["loss"])
                    if not np.isfinite(loss_now):
                        snap = os.path.join(self.model_path or ".",
                                            f"snapshot_fw_{it}.npz")
                        arrs = {f"param_{k}": v.detach().cpu().numpy()
                                for k, v in zip(m.params._fields, m.params)}
                        arrs.update({f"batch_{k}": np.asarray(
                            v.cpu() if isinstance(v, torch.Tensor) else v)
                            for k, v in batch.items()})
                        if self.rank == 0:
                            np.savez(snap, **arrs)
                        raise FloatingPointError(
                            f"non-finite loss {loss_now} at iteration {it}; "
                            f"step inputs dumped to {snap}")

                # Capacity management with an adaptive check cadence:
                # reading a step's counts back waits for the card, so the
                # metrics of earlier steps are read every iteration only
                # near the capacity limits (or after an overflow or a
                # densification, where demand jumps), every 3 or 10
                # otherwise.  Metrics from before the last resize are stale
                # and skipped.
                with tracing.span("iter.capacity"):
                    self._pending_checks.append(
                        (it, metrics["num_padded"], metrics["num_rendered"],
                         metrics["overflow"], self.max_instances))
                    if it % self._check_interval == 0:
                        while len(self._pending_checks) > 2:
                            (cit, p_np, p_nr, p_ov,
                             p_mi) = self._pending_checks.popleft()
                            if p_mi != self.max_instances:
                                continue
                            with tracing.sync(2):
                                npad, ov = int(p_np), bool(p_ov)
                            util = npad / max(self.max_instances, 1)
                            self._check_interval = (
                                1 if ov or util > 0.8
                                else 3 if util > 0.55 else 10)
                            self._manage_capacity(cit, npad, ov)

                if it % log_every == 0 or it == iterations:
                    with tracing.span("iter.log"):
                        with tracing.sync():
                            loss = float(metrics["loss"])
                        self.ema_loss = 0.4 * loss + 0.6 * self.ema_loss
                        if callback:
                            callback(it, metrics, self)
                        # graceful external stop: touching <model_path>/STOP
                        # ends the run cleanly (checkpoint + PLY)
                        stop = self._stop_requested()
                    if stop:
                        print(f"[it {it}] STOP file found — saving and "
                              "exiting")
                        if self.rank == 0:
                            self.scene.save(it)
                            m.save_checkpoint(os.path.join(
                                self.model_path, f"chkpnt{it}.npz"), it)
                        break

                # densification schedule (train.py:169-180)
                if it < opt.densify_until_iter:
                    with tracing.span("iter.densify"):
                        self._densify(it)

            if self.rank != 0:
                continue    # rank 0 writes the files and evaluates
            if it in save_iterations:
                print(f"\n[ITER {it}] Saving Gaussians")
                self.scene.save(it)
                if self.appearance is not None and self.model_path:
                    # beside the PLY, like the reference's
                    # appearance_embedding.ckpt (train.py:164-167)
                    self.appearance.save(os.path.join(
                        self.model_path, "point_cloud", f"iteration_{it}",
                        "appearance_embedding.npz"))
            if it in checkpoint_iterations and self.model_path:
                print(f"\n[ITER {it}] Saving Checkpoint")
                m.save_checkpoint(
                    os.path.join(self.model_path, f"chkpnt{it}.npz"), it)
                if self.appearance is not None:
                    self.appearance.save(
                        os.path.join(self.model_path,
                                     f"appearance_chkpnt{it}.npz"),
                        with_opt=True)
            if it in test_iterations:
                self.report_test(it)
        if prof is not None:
            prof.stop()
            _end_trace(traced)
        return time.time() - t_start

    def _densify(self, it):
        """Densify and prune, and reset the opacities, where the schedule
        (train.py:169-180) says so."""
        opt, m = self.opt, self.model
        if (it > opt.densify_from_iter
                and it % opt.densification_interval == 0):
            size_thr = 20.0 if it > opt.opacity_reset_interval else 0.0
            m.params, m.aux, m.opt_state, dstats = densify_and_prune(
                m.params, m.aux, m.opt_state,
                opt.densify_grad_threshold, 0.005,
                self.scene.cameras_extent, size_thr,
                opt.percent_dense,
                use_screen_size=it > opt.opacity_reset_interval,
                vs_prune=self.vs_prune, generator=self.generator)
            with tracing.sync(5):
                self.last_densify = {
                    "iter": it, "n_cloned": int(dstats.n_cloned),
                    "n_split": int(dstats.n_split),
                    "n_pruned": int(dstats.n_pruned),
                    "n_dropped": int(dstats.n_dropped),
                    "n_alive": int(dstats.n_alive)}
            if self.last_densify["n_dropped"]:
                print(f"[it {it}] WARNING: "
                      f"{self.last_densify['n_dropped']} densify "
                      "targets dropped (capacity full)")
            self._check_interval = 1  # demand just jumped stepwise
        if it % opt.opacity_reset_interval == 0 or (
                self.white_background
                and it == opt.densify_from_iter):
            # second clause: reference train.py:178-180 resets once
            # at densify_from_iter on white-background datasets
            m.params, m.opt_state = reset_opacity(
                m.params, m.aux, m.opt_state)
            self._reset_iter = it

    def _stop_requested(self) -> bool:
        """Whether ``<model_path>/STOP`` exists; over several ranks, whether
        any rank saw it, so that every rank stops at the same iteration."""
        seen = bool(self.model_path) and os.path.exists(
            os.path.join(self.model_path, "STOP"))
        if self.mesh is None:
            return seen
        import torch.distributed as dist
        flag = torch.tensor([int(seen)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        with tracing.sync():
            return bool(flag)

    def _poll_gui(self):
        """Serve the viewer's camera messages, if a client is connected,
        with ``renderer.render`` at the ``Trainer``'s background, backend
        and instance capacity."""
        from gsplat_tpu_torch.renderer import render as render_fn
        from gsplat_tpu_torch.viz import network_gui
        if network_gui.listener is None:
            return
        network_gui.poll_and_render(
            self.model, self.gui_source_path,
            lambda cam, g, sm: render_fn(
                cam, g, bg_color=self.bg, scaling_modifier=sm,
                backend=self.backend, max_instances=self.max_instances,
                device=self.device))

    def _get_batch(self, cams, i):
        """Per-camera device batch through the bounded LRU cache (cap
        ``gt_cache`` entries — see __init__)."""
        b = self._batches.get(i)
        if b is None:
            b = camera_batch(cams[i], device=self.device)
            self._batches[i] = b
            while len(self._batches) > self._gt_cache:
                self._batches.popitem(last=False)
        else:
            self._batches.move_to_end(i)
        return b

    def _manage_capacity(self, it, npad: int, overflow: bool):
        """Densification grows instance demand; regrow the fixed capacity
        BEFORE overflow corrupts a step, and at once if one did overflow.
        ``npad`` is the true padded demand (instances + per-tile alignment
        pads) measured by the binning itself."""
        if overflow or npad > 0.9 * self.max_instances:
            needed = int(npad * 1.35)
            if overflow:
                print(f"[it {it}] WARNING: instance capacity "
                      f"overflow (padded demand {npad}) — regrowing")
                # grow geometrically (>= 2x): explosive densification would
                # otherwise overflow again at every doubling
                needed = max(needed, 2 * self.max_instances)
            self._resize_capacity(needed)
            self._resize_iter = it
            print(f"[it {it}] instance capacity -> {self.max_instances}")
        elif npad < 0.5 * self.max_instances and \
                self.max_instances > (1 << 18) and \
                it - self._resize_iter >= 200 and \
                it - self._reset_iter >= 500:
            # shrink toward ~65% utilization: wide hysteresis against the
            # 90% grow trigger, a 200-iteration cooldown after any resize,
            # and a 500-iteration hold-off after opacity resets (a reset
            # halves instance demand for ~100 iterations; shrinking into
            # that dip would force a paired regrow)
            self._resize_capacity(int(npad * 1.5))
            self._resize_iter = it
            print(f"[it {it}] instance capacity shrunk -> "
                  f"{self.max_instances}")

    def report_test(self, it):
        """Periodic eval over the test split and a 5-camera train sample,
        mirroring the reference's training_report (train.py:227-253).
        Results are appended to <model_path>/eval_log.jsonl."""
        from gsplat_tpu_torch.renderer import render as render_fn
        train_cams = self.scene.getTrainCameras()
        configs = [("test", self.scene.getTestCameras()),
                   ("train", [train_cams[idx % len(train_cams)]
                              for idx in range(5, 30, 5)] if train_cams
                    else [])]
        result = None
        records = []
        with torch.no_grad():
            for name, cams in configs:
                if not cams:
                    continue
                l1s, psnrs, ssims = [], [], []
                for cam in cams:
                    out = render_fn(cam, self.model, bg_color=self.bg,
                                    backend=self.backend,
                                    max_instances=self.max_instances,
                                    device=self.device)
                    img = torch.clamp(out["render"], 0, 1)
                    gt = torch.as_tensor(np.asarray(cam.image),
                                         dtype=torch.float32,
                                         device=self.device)
                    l1s.append(float(L.l1_loss(img, gt)))
                    psnrs.append(float(L.psnr(img, gt)))
                    ssims.append(float(L.ssim(img, gt)))
                print(f"\n[ITER {it}] Evaluating {name}: L1 "
                      f"{np.mean(l1s):.4f} PSNR {np.mean(psnrs):.2f} SSIM "
                      f"{np.mean(ssims):.4f}")
                records.append({"iter": it, "split": name,
                                "n_cams": len(cams),
                                "l1": float(np.mean(l1s)),
                                "psnr": float(np.mean(psnrs)),
                                "ssim": float(np.mean(ssims))})
                if result is None:
                    result = float(np.mean(psnrs))
        if self.model_path and records:
            with open(os.path.join(self.model_path, "eval_log.jsonl"),
                      "a") as f:
                for r in records:
                    f.write(json.dumps(r) + "\n")
        return result
