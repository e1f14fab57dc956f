"""Camera-batch data parallelism (PyTorch port of
``gsplat_tpu/parallel/data_parallel.py``).

A ``("data",)`` mesh of D ranks, one training camera per rank per step, the
gaussian parameters replicated on every rank.  Each rank runs the
single-device step body (``train/trainer.py::_make_step``) on its own
camera, with a reduction hook between the gradient and Adam that does what
the JAX step does inside ``shard_map``:

- the gradients and ``loss``, ``l1``, ``depth_loss``, ``seg_loss`` are
  averaged over the ranks (``pmean``: SUM, then a division by D);
- the means2d gradient is not reduced: each rank takes its own norm, and
  the increments of ``xyz_gradient_accum`` and ``denom`` are summed,
  ``max_radii2d`` is the maximum (``psum``, ``pmax``);
- the overflow flag is the maximum before the overflow gate, so every rank
  keeps or drops the step together; ``num_rendered``, ``num_padded`` and
  ``n_visible`` are maxima;
- in the appearance step the embedding's gradient is summed (each camera
  touches only its own row) and the MLP's is averaged.

Every rank then applies the same Adam update to the same state, so the
replicated state stays bit-identical on every rank.  Where the JAX step
folds the device index into its key, each rank takes its own
``torch.Generator`` (or, in the tests, the draws of JAX's folded key).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from gsplat_tpu_torch.parallel import Axis, make_mesh, mesh_axis
from gsplat_tpu_torch.train.trainer import _make_step

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX


def make_data_mesh(n_devices: Optional[int] = None, device="cuda"):
    """A ``("data",)`` mesh of ``n_devices`` ranks (default: the world)."""
    n = n_devices or dist.get_world_size()
    return make_mesh((n,), ("data",), device)


def stack_camera_batches(batches: list) -> dict:
    """Stack per-camera batches along a leading ``data`` axis: tensors with
    ``torch.stack``, plain numbers (``tan_fovx``, ``tan_fovy``) as tuples,
    so that a step's ``batch[k][i]`` gives camera ``i``'s value as
    ``camera_batch`` made it."""
    return {k: (torch.stack([b[k] for b in batches])
                if isinstance(batches[0][k], torch.Tensor)
                else tuple(b[k] for b in batches))
            for k in batches[0]}


def local_camera(batch: dict) -> dict:
    """This rank's camera of its stacked batch (leading dimension 1)."""
    return {k: v[0] for k, v in batch.items()}


def all_reduce_flat(tensors, op, axis: Axis):
    """``dist.all_reduce`` of same-dtype tensors as one flat buffer (one
    collective); returns the reduced tensors in their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=op, group=axis.group)
    return [x.view_as(t) for x, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class DataReduce:
    """The reduction hook of ``trainer._make_step`` over a ``data`` axis
    (the JAX step's ``pmean``, ``psum`` and ``pmax``, lines :86-121 and
    :165-176); the 2-D mesh's step (``tile_parallel.make_sliced_step``)
    takes it too, after summing each camera's slices."""

    def __init__(self, data: Axis, app: bool):
        self.data = data
        self.app = app

    def grads(self, grads, n):
        """Mean over the data axis of every gradient but the means2d
        offsets' (``grads[n]``); with the appearance, the embedding's
        (``grads[n + 1]``) is a sum."""
        idx = [i for i in range(len(grads)) if i != n]
        red = all_reduce_flat([grads[i] for i in idx], SUM, self.data)
        out = list(grads)
        for i, g in zip(idx, red):
            out[i] = g if (self.app and i == n + 1) else g / self.data.size
        return out

    def stats(self, aux, g, radii):
        """``add_densification_stats`` with the increments summed and the
        screen radii's maximum taken over the data axis."""
        vis = radii > 0
        gnorm = torch.sqrt(torch.sum(g[:, :2] * g[:, :2], dim=-1))
        inc = all_reduce_flat([torch.where(vis, gnorm, 0.0),
                               vis.to(torch.float32)], SUM, self.data)
        mx = torch.where(vis, torch.maximum(aux.max_radii2d,
                                            radii.to(torch.float32)),
                         aux.max_radii2d)
        dist.all_reduce(mx, op=MAX, group=self.data.group)
        return aux._replace(xyz_gradient_accum=aux.xyz_gradient_accum
                            + inc[0], denom=aux.denom + inc[1],
                            max_radii2d=mx)

    def metrics(self, metrics):
        means = ("loss", "l1", "depth_loss", "seg_loss")
        maxes = ("overflow", "num_rendered", "num_padded", "n_visible")
        out = dict(metrics)
        for k, v in zip(means, all_reduce_flat(
                [metrics[k].reshape(1) for k in means], SUM, self.data)):
            out[k] = v[0] / self.data.size
        for k, v in zip(maxes, all_reduce_flat(
                [metrics[k].to(torch.int64).reshape(1) for k in maxes], MAX,
                self.data)):
            out[k] = v[0].to(metrics[k].dtype)
        return out


def make_parallel_train_step(mesh, cfg, opt, sh_degree: int,
                             depth_loss_choice, use_seg: bool, bg,
                             track_stats: bool = True, device="cuda"):
    """Returns ``step(params, opt_state, aux, batch, lrs, generator=None,
    draws=None) -> (params, opt_state, aux, metrics)``, the same on every
    rank of ``mesh``'s ``data`` axis.  ``batch`` is this rank's shard of the
    stacked camera batch (``stack_camera_batches`` of its one camera);
    ``generator`` or ``draws`` are this rank's own."""
    body = _make_step(cfg, opt, sh_degree, depth_loss_choice, use_seg, bg,
                      track_stats, 0.0, False, False, device,
                      reduce=DataReduce(mesh_axis(mesh, "data"), app=False))

    def step(params, opt_state, aux, batch, lrs, generator=None, draws=None):
        return body(params, opt_state, aux, (), local_camera(batch), lrs,
                    generator, draws)

    return step


def make_parallel_appearance_step(mesh, cfg, opt, sh_degree: int,
                                  depth_loss_choice, use_seg: bool, bg,
                                  app_lr: float = 1e-4,
                                  track_stats: bool = True, device="cuda"):
    """The data-parallel step with the per-camera appearance embedding
    (JAX ``make_parallel_appearance_step``): ``step(params, opt_state, aux,
    app_params, app_opt_state, batch, lrs, generator=None, draws=None)``.
    Each rank looks up its own camera's embedding row; that row's gradient
    is summed over the ranks, the MLP's averaged."""
    body = _make_step(cfg, opt, sh_degree, depth_loss_choice, use_seg, bg,
                      track_stats, app_lr, False, False, device,
                      reduce=DataReduce(mesh_axis(mesh, "data"), app=True))

    def step(params, opt_state, aux, app_params, app_opt_state, batch, lrs,
             generator=None, draws=None):
        return body(params, opt_state, aux, (app_params, app_opt_state),
                    local_camera(batch), lrs, generator, draws)

    return step
