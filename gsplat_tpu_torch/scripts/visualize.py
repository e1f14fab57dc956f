"""Offline visualizer and editor CLI (PyTorch port of
``gsplat_tpu/scripts/visualize.py``; the reference's taichi GUI,
visualizer.py, made headless).

Renders RGB / depth / segment-argmax views along a camera orbit through the
scene's cameras, applies bbox crops, class filters and sub-scene merges
(``viz/editor.py``), and exports frames or a video:

python -m gsplat_tpu_torch.scripts.visualize -m <model>
    [--mode rgb|depth|segment] [--orbit_frames 24]
    [--bbox cx cy cz ex ey ez] [--bbox_rot rx ry rz]
    [--sub_scene extra1.ply extra2.ply] [--segment_class K]
    [--save_clip out.ply] [--video] [--backend auto|pallas|jnp|reference]
    [--data_device cpu]

Every frame is ``renderer.render`` on the model's ``--data_device``
(``cuda`` by default, or the value in ``cfg_args``): with ``--backend
auto`` it launches the expansion kernel K3 and the forward composite kernel
K1 once.  As in the render CLI, the model is sized to its PLY (the JAX CLI
allocates 2^19 slots; a merge grows it); dead slots render nothing, so the
frames are the same.
"""
from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np

_PALETTE = None


def segment_palette(num_class: int) -> np.ndarray:
    """Random color palette per class (visualizer.py:547-557)."""
    global _PALETTE
    if _PALETTE is None or len(_PALETTE) < num_class:
        rng = np.random.default_rng(12345)
        _PALETTE = rng.uniform(0.15, 1.0, (max(num_class, 8), 3))
    return _PALETTE[:num_class]


def frame_for_mode(out, mode: str, num_class: int) -> np.ndarray:
    """The [H, W, 3] host frame of ``renderer.render``'s output in ``mode``;
    one readback of the one tensor the mode needs (the segment mode reads
    back the per-pixel argmax class)."""
    if mode == "depth":
        d = out["depth"].cpu().numpy()
        return np.repeat((d / (d.max() + 1e-9))[..., None], 3, -1)
    if mode == "segment":
        seg = out["segment"]
        pal = segment_palette(seg.shape[0])
        return pal[seg.argmax(0).cpu().numpy()]
    img = np.clip(out["render"].cpu().numpy(), 0, 1)
    return img.transpose(1, 2, 0)


def build_parser():
    from gsplat_tpu_torch.config import ModelParams, PipelineParams

    parser = ArgumentParser(description="Offline visualizer parameters")
    model = ModelParams(parser, sentinel=True)
    PipelineParams(parser)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--mode", default="rgb",
                        choices=["rgb", "depth", "segment"])
    parser.add_argument("--orbit_frames", default=24, type=int)
    parser.add_argument("--bbox", nargs=6, type=float, default=None,
                        help="cx cy cz ex ey ez rotated-box crop")
    parser.add_argument("--bbox_rot", nargs=3, type=float, default=[0, 0, 0])
    parser.add_argument("--sub_scene", nargs="*", default=None,
                        help="extra PLYs merged into the scene")
    parser.add_argument("--segment_class", default=-1, type=int,
                        help="show only gaussians of this argmax class")
    parser.add_argument("--save_clip", default=None, type=str)
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--backend", default="auto", type=str)
    parser.add_argument("--out", default=None, type=str)
    return parser, model


def main(argv=None):
    """The command line ``argv`` (default ``sys.argv[1:]``); returns the
    host frames it wrote."""
    import torch

    from gsplat_tpu_torch.config import get_combined_args
    from gsplat_tpu_torch.core.cameras import MiniCam, get_projection_matrix
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.renderer import render
    from gsplat_tpu_torch.viz.camera_trajectory import inter_poses
    from gsplat_tpu_torch.viz.editor import SceneEditor
    from gsplat_tpu_torch.viz.video import save_frames, save_video

    parser, model = build_parser()
    args = get_combined_args(parser, sys.argv[1:] if argv is None else argv)
    dataset = model.extract(args)
    device = resolve_device(dataset.data_device or "cuda")
    gaussians = GaussianModel(dataset.sh_degree,
                              num_class=getattr(dataset, "num_class", 2),
                              capacity=1, device=device)
    scene = Scene(dataset, gaussians, load_iteration=args.iteration,
                  shuffle=False, low_memory=True)
    editor = SceneEditor(gaussians)

    for ply in (args.sub_scene or []):
        iid = editor.merge_ply(ply)
        print(f"merged sub-scene {ply} as instance {iid}")

    mask = None
    if args.bbox is not None:
        mask = editor.bbox_select(args.bbox[:3], tuple(args.bbox_rot),
                                  args.bbox[3:])
        print(f"bbox crop selects {int(mask.sum())} gaussians")
    if args.segment_class >= 0:
        smask = editor.segment_select(args.segment_class)
        mask = smask if mask is None else (mask & smask)
        print(f"class filter selects {int(mask.sum())} gaussians")

    if args.save_clip:
        editor.save_clip(args.save_clip,
                         mask if mask is not None else editor.alive_mask())
        print(f"saved clip to {args.save_clip}")

    cams = scene.getTrainCameras() or scene.getTestCameras()
    keys = [c.world_view_transform for c in cams[:: max(1, len(cams) // 6)]]
    path = inter_poses(keys + [keys[0]], args.orbit_frames)

    template = cams[0]
    proj = getattr(template, "projection_matrix", None)
    if proj is None:
        proj = get_projection_matrix(0.01, 100.0, template.FoVx,
                                     template.FoVy).T
    # the mask goes to the device once, not once a frame
    bbox = torch.as_tensor(mask, device=device) if mask is not None else None
    frames = []
    for M in path:
        cam = MiniCam(template.image_width, template.image_height,
                      template.FoVy, template.FoVx, 0.01, 100.0,
                      M.astype(np.float32), (M @ proj).astype(np.float32))
        out = render(cam, gaussians, backend=args.backend, bbox_mask=bbox,
                     device=device)
        frames.append(frame_for_mode(out, args.mode, gaussians.num_class))

    out_base = args.out or os.path.join(dataset.model_path, f"viz_{args.mode}")
    if args.video:
        save_video(frames, out_base + ".mp4")
    else:
        save_frames(frames, out_base)
    print(f"wrote {len(frames)} frames to {out_base}")
    return frames


if __name__ == "__main__":
    main()
