"""Offline render CLI (PyTorch port of ``gsplat_tpu/scripts/render.py``,
mirror of reference render.py:26-126).

python -m gsplat_tpu_torch.scripts.render -m <model> [--skip_train --skip_test]
    [--inter_test_frames N] [--render_file poses_render.npy] [--video]
    [--set_video plain|depth] [--data_device cpu]

Renders the model's last saved iteration (or ``--iteration``) on its
``--data_device``: ``cuda`` by default, ``cpu`` where the caller asks for
it (every kernel's plain version).  Writes what the JAX CLI writes:
``<model>/<split>/ours_<iter>/{renders,gt,depth}/<idx>.png``, then
``path_renders/`` (or ``path.mp4`` with ``--video``) for an interpolated
or replayed camera path, and a set video with ``--set_video``.

``--tile_parallel N`` renders each train and test view split by tile rows
over N devices, one process each (``parallel/tile_parallel.py``, bit-equal
to the single-device render): started alone the command starts N local
ranks, under ``torchrun`` it joins the launched group, and rank 0 writes
every file.  ``--backend``: ``auto`` (the default) or ``pallas`` composite
with kernel K1, ``jnp`` or ``reference`` with the plain-torch tiled
compositor (``ops/composite_tiled.py``).
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np

from gsplat_tpu_torch.utils.general import quantize


def render_set(model_path, name, iteration, views, gaussians, background,
               backend="auto", renderer=None):
    """render.py:26-43: save render/gt/depth PNGs per view."""
    from PIL import Image

    from gsplat_tpu_torch.renderer import render

    render_path = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gts_path = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    depth_path = os.path.join(model_path, name, f"ours_{iteration}", "depth")
    for p in (render_path, gts_path, depth_path):
        os.makedirs(p, exist_ok=True)

    for idx, view in enumerate(views):
        out = (renderer(view) if renderer is not None else
               render(view, gaussians, bg_color=background, backend=backend,
                      device=gaussians.device))
        Image.fromarray(quantize(out["render"].cpu().numpy())).save(
            os.path.join(render_path, f"{idx:05d}.png"))
        Image.fromarray(quantize(np.asarray(view.image))).save(
            os.path.join(gts_path, f"{idx:05d}.png"))
        d = out["depth"].cpu().numpy()
        d = d / (d.max() + 1e-9)
        Image.fromarray((d * 255).astype(np.uint8)).save(
            os.path.join(depth_path, f"{idx:05d}.png"))
    return render_path


def render_path_frames(views_matrices, template_cam, gaussians, background,
                       backend="auto"):
    """Render a sequence of world-view matrices with a template camera's
    intrinsics (render.py:45-80); frames as host [3, H, W] float arrays."""
    from gsplat_tpu_torch.core.cameras import MiniCam
    from gsplat_tpu_torch.renderer import render

    frames = []
    proj = template_cam.projection_matrix
    for M in views_matrices:
        cam = MiniCam(template_cam.image_width, template_cam.image_height,
                      template_cam.FoVy, template_cam.FoVx,
                      template_cam.znear if hasattr(template_cam, "znear") else 0.01,
                      getattr(template_cam, "zfar", 100.0),
                      M.astype(np.float32), (M @ proj).astype(np.float32))
        out = render(cam, gaussians, bg_color=background, backend=backend,
                     device=gaussians.device)
        frames.append(out["render"].cpu().numpy())
    return frames


def make_tile_renderer(n: int, scene, gaussians, background, backend,
                       sh_degree: int):
    """The view renderer with each image's tile rows split over ``n`` ranks
    of the process group (``parallel/tile_parallel.py``), bit-equal to the
    single-device render; every rank calls it for every view.  The height
    must split into whole ``TILE_Y`` rows per rank (``ValueError``
    otherwise; the JAX CLI checks 16-px rows, which its own slicing then
    refuses at 32-px tiles)."""
    import torch

    from gsplat_tpu_torch.core import transforms as Tr
    from gsplat_tpu_torch.ops.preprocess import TILE_Y
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.parallel.tile_parallel import (
        make_tile_mesh, make_tile_sharded_render, slice_camera)

    cams = scene.getTrainCameras() or scene.getTestCameras()
    W, H = cams[0].image_width, cams[0].image_height
    if H % (TILE_Y * n) != 0:
        raise ValueError(f"--tile_parallel {n} needs image height ({H}) to "
                         f"split into whole {TILE_Y}-px tile rows per device")
    dev = gaussians.device
    cfg = RasterizeConfig(width=W, height=H, sh_degree=sh_degree,
                          max_instances=1 << 20, backend=backend)
    fn = make_tile_sharded_render(make_tile_mesh(n, dev), cfg, device=dev)
    p = gaussians.params
    bg = torch.as_tensor(background, dtype=torch.float32, device=dev)

    def tile_render(view):
        out = fn(p.xyz, Tr.scaling_activation(p.scaling), p.rotation,
                 Tr.opacity_activation(p.opacity[:, 0]),
                 torch.cat([p.features_dc, p.features_rest], dim=1),
                 slice_camera(view, n, dev), bg)
        if bool(out["overflow"]):
            print("[render] WARNING: instance capacity overflow on "
                  "view — raise max_instances")
        return out

    return tile_render


def build_parser():
    from gsplat_tpu_torch.config import ModelParams, PipelineParams

    parser = ArgumentParser(description="Testing script parameters")
    model = ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--inter_test_frames", default=0, type=int)
    parser.add_argument("--render_file", default=None, type=str)
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--set_video", choices=["plain", "depth"],
                        default=None,
                        help="export each rendered set as an mp4; 'depth' "
                             "composites the depth pane side-by-side "
                             "(composite_video.py save_vidio)")
    parser.add_argument("--backend", default="auto", type=str)
    parser.add_argument("--tile_parallel", default=1, type=int,
                        help="shard each image's tile rows over N devices "
                             "(bit-exact vs single-device)")
    return parser, model


def main(argv=None):
    from gsplat_tpu_torch.config import get_combined_args
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.parallel import multihost as mh

    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_combined_args(build_parser()[0], argv)
    if args.tile_parallel > 1 and mh.launched():
        mh.init_multihost(device=args.data_device or "cuda")
        try:
            render_rank(argv)
        finally:
            import torch.distributed as dist
            dist.destroy_process_group()
    elif args.tile_parallel > 1:
        device = resolve_device(args.data_device or "cuda")
        n = mh.local_ranks(1, args.tile_parallel, device)
        mh.spawn_local(render_rank, n, (argv,), device=device)
    else:
        render_rank(argv)


def render_rank(argv):
    """The render command in one process, or in one rank of a tile-sharded
    render (the group already started): rank 0 writes every file, the
    other ranks render their slices of the same views."""
    import torch.distributed as dist

    from gsplat_tpu_torch.config import get_combined_args

    parser, model = build_parser()
    args = get_combined_args(parser, argv)
    rank = dist.get_rank() if dist.is_initialized() else 0
    print("Rendering " + args.model_path)

    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.viz.camera_trajectory import inter_poses, load_poses

    dataset = model.extract(args)
    device = resolve_device(dataset.data_device or "cuda")
    # capacity 1: load_ply sizes the model to the PLY (the next power of two
    # above its count) where the JAX CLI takes its default 2^19 slots; dead
    # slots render nothing, so the images are the same
    gaussians = GaussianModel(dataset.sh_degree,
                              num_class=getattr(dataset, "num_class", 2),
                              capacity=1, device=device)
    scene = Scene(dataset, gaussians, load_iteration=args.iteration,
                  shuffle=False)
    background = np.ones(3) if dataset.white_background else np.zeros(3)

    renderer = None
    if args.tile_parallel > 1:
        renderer = make_tile_renderer(args.tile_parallel, scene, gaussians,
                                      background, args.backend,
                                      dataset.sh_degree)
    elif (getattr(args, "convert_SHs_python", False)
          or getattr(args, "compute_cov3D_python", False)):
        # pipe debug backends: SH->RGB / cov3D computed in torch and fed as
        # precomputed inputs (reference gaussian_renderer/__init__.py:341-359)
        from gsplat_tpu_torch.renderer import render as _render
        renderer = lambda view: _render(  # noqa: E731
            view, gaussians, bg_color=background, backend=args.backend,
            convert_SHs_python=bool(getattr(args, "convert_SHs_python",
                                            False)),
            compute_cov3D_python=bool(getattr(args, "compute_cov3D_python",
                                              False)),
            device=device)
    if rank != 0:
        # the other ranks' part: their slices of the views rank 0 writes
        for view in ((scene.getTrainCameras() if not args.skip_train else [])
                     + (scene.getTestCameras() if not args.skip_test
                        else [])):
            renderer(view)
        return
    if not args.skip_train:
        render_set(dataset.model_path, "train", scene.loaded_iter,
                   scene.getTrainCameras(), gaussians, background,
                   args.backend, renderer=renderer)
    if not args.skip_test:
        render_set(dataset.model_path, "test", scene.loaded_iter,
                   scene.getTestCameras(), gaussians, background,
                   args.backend, renderer=renderer)

    if getattr(args, "set_video", None):
        # set-level mp4 export: plain or with the side-by-side depth pane
        # (reference composite_video.py save_vidio / save_vidio_no_depth)
        from gsplat_tpu_torch.viz.video import save_vidio, save_vidio_no_depth
        writer = (save_vidio if args.set_video == "depth"
                  else save_vidio_no_depth)
        for name, skip in (("train", args.skip_train),
                           ("test", args.skip_test)):
            if not skip:
                print("set video:",
                      writer(dataset.model_path, name, scene.loaded_iter))

    frames = None
    cams = scene.getTrainCameras() or scene.getTestCameras()
    if args.inter_test_frames:
        keys = [c.world_view_transform for c in
                (scene.getTestCameras() or cams)]
        path = inter_poses(keys, args.inter_test_frames)
        frames = render_path_frames(path, cams[0], gaussians, background,
                                    args.backend)
    elif args.render_file:
        path = load_poses(args.render_file)
        frames = render_path_frames(path, cams[0], gaussians, background,
                                    args.backend)

    if frames is not None:
        out_dir = os.path.join(dataset.model_path, "path_renders")
        if args.video:
            from gsplat_tpu_torch.viz.video import save_video
            save_video(frames, os.path.join(dataset.model_path, "path.mp4"))
        else:
            from gsplat_tpu_torch.viz.video import save_frames
            save_frames(frames, out_dir)


if __name__ == "__main__":
    main()
