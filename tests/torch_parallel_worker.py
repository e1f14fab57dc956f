"""One rank of the port's multi-device tests (``tests/test_torch_parallel.py``).

Run as ``python tests/torch_parallel_worker.py <rank> <world> <port> <dir>``
by the test's module fixture: four gloo ranks on the CPU, started once.
Imports torch, numpy and the port only (as ``multihost_worker.py`` imports
JAX only), so that a rank does not load JAX.  Every rank builds the same
inputs (``make_inputs``), reads the warm state and the JAX draws the test
wrote to ``<dir>/inputs.npz``, runs every scenario over a 2x2 mesh and its
1-D sub-meshes and writes ``<dir>/rank<r>.npz``:

- ``a``: the data-parallel step and its appearance form over the ``data``
  axis (cameras 0 and 1);
- ``b``: the tile-sharded render and the tile-sharded step (and its
  appearance form) over the ``tile`` axis, with the single-device render
  and steps on the same inputs;
- ``c``: the 2x2 mesh step, and the ``ValueError`` of a 3x2 mesh;
- ``d``: a ``Trainer`` with ``data_parallel=2`` (two replicas of two ranks)
  for 3 iterations with one densify, on the scene in ``<dir>/scene``.

The oracles of the appearance and 2x2 steps (the mean over per-camera
gradients of the single-device loss) are made here, on rank 0.
"""
import argparse
import datetime
import math
import os
import random
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W = H = 64
N_LIVE, CAP = 200, 256
BG = np.array([0.1, 0.3, 0.2], np.float32)
DEPTH = "continue_loss"        # a depth loss that draws


def make_camera(dist):
    from gsplat_tpu_torch.core.cameras import Camera
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    return Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, dist]),
                  FoVx=fovx, FoVy=fovy,
                  image=np.zeros((3, H, W), np.float32), image_name="test",
                  uid=0)


def make_inputs(seed=12):
    """The cold model and two cameras with their ground truth, as numpy
    (the same in the test and in every rank)."""
    rng = np.random.default_rng(seed)
    K, f32 = 16, np.float32
    p = dict(xyz=np.full((CAP, 3), 1e8, f32),
             features_dc=np.zeros((CAP, 1, 3), f32),
             features_rest=np.zeros((CAP, K - 1, 3), f32),
             scaling=np.zeros((CAP, 3), f32),
             rotation=np.tile(np.array([1, 0, 0, 0], f32), (CAP, 1)),
             opacity=np.full((CAP, 1), -30.0, f32),
             segment=np.zeros((CAP, 2), f32))
    n = N_LIVE
    p["xyz"][:n] = rng.standard_normal((n, 3)) * 1.2
    p["features_dc"][:n] = rng.standard_normal((n, 1, 3)) * 0.8
    p["features_rest"][:n] = rng.standard_normal((n, K - 1, 3)) * 0.2
    p["scaling"][:n] = rng.standard_normal((n, 3)) * 0.5 - 2.5
    p["rotation"][:n] = rng.standard_normal((n, 4))
    p["opacity"][:n] = rng.standard_normal((n, 1)) * 1.5
    p["segment"][:n] = rng.standard_normal((n, 2))
    cams = []
    for i, dist in enumerate((3.6, 4.2)):
        cam = make_camera(dist)
        cam.uid = i
        cam.image = rng.uniform(size=(3, H, W)).astype(f32)
        # plateaus with small steps, so the continuity mask is not empty
        depth = (np.round(rng.uniform(0.1, 2.0, (1, H, W)), 1)
                 + 5e-4 * rng.integers(0, 3, (1, H, W))).astype(f32)
        seg = rng.integers(0, 2, (H, W)).astype(np.int32)
        cams.append((cam, depth, seg))
    emb = (rng.standard_normal((2, 16)) * 0.5).astype(f32)
    return p, np.arange(CAP) < n, cams, emb


def configs():
    from gsplat_tpu_torch import config
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    cfg = RasterizeConfig(width=W, height=H, num_class=2,
                          max_instances=1 << 13)
    return cfg, config.OptimizationParams()


def batches(cams):
    from gsplat_tpu_torch.train.trainer import camera_batch
    return [camera_batch(c, gt_depth=d, gt_seg=s, device="cpu")
            for c, d, s in cams]


def mean_step(cfg, opt, state, app, bats, draws, lrs):
    """The single-device oracle of a step over several cameras: the mean of
    the per-camera gradients of ``make_loss_fn`` (the embedding's summed),
    the per-camera densification statistics, Adam and the appearance's
    Adam (as ``tests/test_mesh2d.py`` builds it for JAX)."""
    from gsplat_tpu_torch.models import adam
    from gsplat_tpu_torch.models.densify import add_densification_stats
    from gsplat_tpu_torch.models.gaussians import GaussianParams
    from gsplat_tpu_torch.train.trainer import make_loss_fn
    params, opt_state, aux = state
    loss_fn = make_loss_fn(cfg, opt, 3, DEPTH, True, BG, device="cpu")
    scale = torch.tensor([0.5 * cfg.width, 0.5 * cfg.height])
    gsum = None
    for b, dr in zip(bats, draws):
        leaves = GaussianParams(*[x.detach().requires_grad_(True)
                                  for x in params])
        app_leaves = (type(app[0])(*[x.detach().requires_grad_(True)
                                     for x in app[0]]) if app else ())
        m2d = torch.zeros((params.xyz.shape[0], 2), requires_grad=True)
        loss, auxout = loss_fn(leaves, m2d, b, draws=dr,
                               app_params=app_leaves or None)
        g = torch.autograd.grad(loss, [*leaves, m2d, *app_leaves],
                                allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi
             for gi, x in zip(g, [*leaves, m2d, *app_leaves])]
        aux = add_densification_stats(aux, g[7] * scale, auxout["radii"])
        gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
    M = len(bats)
    gp = GaussianParams(*[x / M for x in gsum[:7]])
    lrs_tree = GaussianParams(**{k: lrs[k] for k in GaussianParams._fields})
    out = (*adam.update(gp, opt_state, params, lrs_tree), aux)
    if app:
        ga = [gsum[8]] + [x / M for x in gsum[9:]]
        out += adam.update(type(app[0])(*ga), app[1], app[0],
                           tuple(1e-4 for _ in ga))
    return out


def flat(prefix, tree, out):
    for k, v in tree._asdict().items():
        if isinstance(v, tuple):
            flat(f"{prefix}{k}.", v, out)
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = v.detach().numpy()


def save_step(prefix, result, out):
    """A step's returned state trees and metrics under ``prefix``."""
    *trees, metrics = result
    names = ("params", "opt", "aux", "app", "app_opt")
    for name, tree in zip(names, trees):
        flat(f"{prefix}{name}.", tree, out)
    for k, v in metrics.items():
        out[f"{prefix}m.{k}"] = np.asarray(v.detach().numpy())


def trainer_run(rank, root, out):
    """``d``: 3 iterations of a data-parallel ``Trainer`` with a densify at
    iteration 2; this rank's model folder is ``<root>/trainer<rank>``."""
    from gsplat_tpu_torch import config
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.train.trainer import Trainer
    path = os.path.join(root, f"trainer{rank}")
    args = argparse.Namespace(
        source_path=os.path.join(root, "scene"), model_path=path,
        images="images", resolution=-1, white_background=False, eval=True,
        using_depth=True, using_seg=True)
    random.seed(0)
    model = GaussianModel(3, num_class=2, capacity=1024, device="cpu")
    scene = Scene(args, model, write_inputs=rank == 0)
    model.training_setup()
    opt = config.OptimizationParams()
    opt.densify_from_iter, opt.densification_interval = 1, 2
    opt.densify_grad_threshold = 2e-6
    tr = Trainer(model, scene, opt, data_parallel=2, max_instances=1 << 14,
                 model_path=path, use_seg=True)
    tr.train(3, save_iterations={3}, checkpoint_iterations={3},
             test_iterations={3}, log_every=1)
    flat("d.params.", model.params, out)
    flat("d.aux.", model.aux, out)
    out["d.densify"] = np.array([tr.last_densify[k] for k in (
        "iter", "n_cloned", "n_split", "n_pruned", "n_alive")])
    out["d.files"] = np.array(sorted(
        os.path.relpath(os.path.join(d, f), path)
        for d, _, fs in os.walk(path) for f in fs) or [""])


def main():
    rank, world, port, root = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.models import appearance as app_lib
    from gsplat_tpu_torch.models import gaussians as tg
    from gsplat_tpu_torch.ops.rasterize import rasterize
    from gsplat_tpu_torch.parallel import data_parallel as dp
    from gsplat_tpu_torch.parallel import mesh2d
    from gsplat_tpu_torch.parallel import tile_parallel as tp
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.parallel.multihost import init_multihost
    from gsplat_tpu_torch.train import trainer as tt
    from gsplat_tpu_torch.train.schedules import make_lr_fn

    init_multihost(f"127.0.0.1:{port}", world, rank, device="cpu",
                   timeout=datetime.timedelta(seconds=120))
    out = {}
    cfg, opt = configs()
    p, alive, cams, emb = make_inputs()
    warm = np.load(os.path.join(root, "inputs.npz"))
    fields = tg.GaussianParams._fields
    params = tg.params_from_numpy(
        dict({k: warm[f"p.{k}"] for k in fields}, alive=alive),
        device="cpu", num_class=2).params
    opt_state = tg.adam_state_from_numpy(
        int(warm["count"]), {k: warm[f"mu.{k}"] for k in fields},
        {k: warm[f"nu.{k}"] for k in fields}, device="cpu")
    aux = tg.aux_from_numpy({k: warm[f"aux.{k}"]
                             for k in tg.GaussianAux._fields}, device="cpu")
    state = (params, opt_state, aux)
    lrs = make_lr_fn(opt, 1.0)(100)
    bats = batches(cams)
    draws = [{k: torch.from_numpy(warm[f"draws{d}.{k}"])
              for k in ("patch_rows", "patch_cols")} for d in range(2)]
    ap = app_lib.init_params(2, device="cpu")._replace(
        emb=torch.from_numpy(emb))
    app = (ap, tg.adam_state_from_numpy(
        3, {k: np.full(v.shape, 1e-4, np.float32)
            for k, v in ap._asdict().items()},
        {k: np.full(v.shape, 1e-6, np.float32)
         for k, v in ap._asdict().items()}, device="cpu",
        tree_type=app_lib.AppearanceParams))

    mesh = mesh2d.make_2d_mesh(2, 2, device="cpu")
    d = mesh.get_local_rank("data")
    # a: the data axis (ranks {0, 2} and {1, 3}), camera d
    step = dp.make_parallel_train_step(mesh["data"], cfg, opt, 3, DEPTH,
                                       True, BG, device="cpu")
    mine = dp.stack_camera_batches([bats[d]])
    save_step("a.", step(*state, mine, lrs, draws=draws[d]), out)
    astep = dp.make_parallel_appearance_step(mesh["data"], cfg, opt, 3,
                                             DEPTH, True, BG, device="cpu")
    save_step("a_app.", astep(*state, *app, mine, lrs, draws=draws[d]), out)

    # b: the tile axis (ranks {0, 1} and {2, 3}), camera 0
    rcfg = RasterizeConfig(width=W, height=H, max_instances=1 << 13)
    g = (params.xyz, T.scaling_activation(params.scaling), params.rotation,
         T.opacity_activation(params.opacity[:, 0]),
         torch.cat([params.features_dc, params.features_rest], dim=1))
    render = tp.make_tile_sharded_render(mesh["tile"], rcfg, device="cpu")
    cam0 = tp.slice_camera(cams[0][0], 2, device="cpu")
    r = render(*g, cam0, BG)
    full = rasterize(rcfg, *g, **cam0, bg=BG, device="cpu")
    for k in ("render", "depth", "alpha", "radii", "visibility", "overflow"):
        out[f"b.tile.{k}"] = r[k].numpy()
        out[f"b.full.{k}"] = full[k].numpy()
    tstep, _ = tp.make_tile_sharded_train_step(mesh["tile"], cfg, opt, 3,
                                               DEPTH, True, BG, device="cpu")
    save_step("b.", tstep(*state, bats[0], lrs, draws=draws[0]), out)
    tastep, _ = tp.make_tile_sharded_train_step(
        mesh["tile"], cfg, opt, 3, DEPTH, True, BG, use_appearance=True,
        device="cpu")
    save_step("b_app.", tastep(*state, *app, bats[0], lrs, draws=draws[0]),
              out)

    # c: the 2x2 mesh, camera d
    s2 = mesh2d.make_2d_train_step(mesh, cfg, opt, 3, DEPTH, True, BG,
                                   device="cpu")
    save_step("c.", s2(*state, mine, lrs, draws=draws[d]), out)
    try:
        mesh2d.make_2d_mesh(3, 2, device="cpu")
    except ValueError as e:
        out["c.error"] = np.array(str(e))

    # d: the Trainer
    trainer_run(rank, root, out)

    if rank == 0:
        # the single-device references
        single = tt.make_train_step(cfg, opt, 3, DEPTH, True, BG,
                                    device="cpu")
        save_step("ref.b.", single(*state, bats[0], lrs, draws=draws[0]),
                  out)
        sapp = tt.make_appearance_step(cfg, opt, 3, DEPTH, True, BG,
                                       device="cpu")
        save_step("ref.b_app.", sapp(*state, *app, bats[0], lrs,
                                     draws=draws[0]), out)
        save_step("ref.mean.", (*mean_step(cfg, opt, state, (), bats, draws,
                                           lrs), {}), out)
        save_step("ref.mean_app.", (*mean_step(cfg, opt, state, app, bats,
                                               draws, lrs), {}), out)
    np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    import torch.distributed as dist
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
