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

Not ported yet, and refused: ``--tile_parallel`` above 1 (ROADMAP Queue 1
item 7); a ``--backend`` other than ``auto`` raises in ``rasterize``
(item 9).
"""
from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np


def quantize(img: np.ndarray) -> np.ndarray:
    """[3, H, W] float -> [H, W, 3] uint8 as the JAX CLI writes it: clipped
    to [0, 1], times 255, truncated."""
    return (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


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
    """The tile-row-sharded view renderer over n devices: not ported
    yet."""
    raise NotImplementedError(
        f"--tile_parallel {n}: the tile-row-sharded renderer is not ported "
        "yet; see ROADMAP.md, Queue 1 item 7")


def main(argv=None):
    from gsplat_tpu_torch.config import (ModelParams, PipelineParams,
                                         get_combined_args)

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
                             "(not ported yet)")
    args = get_combined_args(parser, argv)
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
