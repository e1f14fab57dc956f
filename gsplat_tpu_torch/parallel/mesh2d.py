"""Composed 2-D (data x tile) mesh training (PyTorch port of
``gsplat_tpu/parallel/mesh2d.py``): cameras over the ``data`` axis and each
camera's tile rows over the ``tile`` axis.

Rank (m, n) renders row slice n of camera m (``tile_parallel``'s bit-exact
slices).  The gaussian parameters are replicated.  Within a camera the
slices' gradient partials are summed over the tile group; over the cameras
they are averaged, as the JAX step's mean loss makes them.  The means2d
gradient stays per camera (summed over the tile group only), because the
densification statistics sum the cameras' gradient norms, not the norm of
the summed gradient (train.py:169-180); the embedding's gradient is its
camera's own, the JAX step's ``emb * M``.
"""
from __future__ import annotations

from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
from gsplat_tpu_torch.parallel import make_mesh, mesh_axis
from gsplat_tpu_torch.parallel.data_parallel import local_camera
from gsplat_tpu_torch.parallel.tile_parallel import make_sliced_step


def make_2d_mesh(data: int, tile: int, device="cuda"):
    """A ``("data", "tile")`` mesh of ``data * tile`` ranks; rank ``m *
    tile + n`` is (m, n).  Raises ``ValueError`` when the world has fewer
    ranks, as the JAX function does for devices (``parallel.make_mesh``)."""
    return make_mesh((data, tile), ("data", "tile"), device)


def make_2d_train_step(mesh, cfg_full: RasterizeConfig, opt, sh_degree: int,
                       depth_loss_choice, use_seg: bool, bg,
                       track_stats: bool = True, use_appearance: bool = False,
                       app_lr: float = 1e-4, device="cuda"):
    """``step(params, opt_state, aux, batch, lrs, generator=None,
    draws=None)`` over an (M, N) mesh, or with ``use_appearance`` the
    appearance form ``step(params, opt_state, aux, app_params,
    app_opt_state, batch, lrs, generator=None, draws=None)``.  ``batch`` is
    this rank's shard of the stacked batch: its camera m, the same on every
    rank of its tile group, as are ``generator`` or ``draws``."""
    body = make_sliced_step(mesh_axis(mesh, "data"), mesh_axis(mesh, "tile"),
                            cfg_full, opt, depth_loss_choice, use_seg, bg,
                            track_stats, use_appearance, app_lr, device)
    if use_appearance:
        def app_step(params, opt_state, aux, app_params, app_opt_state,
                     batch, lrs, generator=None, draws=None):
            return body(params, opt_state, aux, (app_params, app_opt_state),
                        local_camera(batch), lrs, generator, draws)
        return app_step

    def step(params, opt_state, aux, batch, lrs, generator=None, draws=None):
        return body(params, opt_state, aux, (), local_camera(batch), lrs,
                    generator, draws)

    return step
