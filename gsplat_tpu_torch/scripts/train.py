"""Training CLI (PyTorch port of ``gsplat_tpu/scripts/train.py``, mirror of
reference train.py:293-328).

Usage: python -m gsplat_tpu_torch.scripts.train -s <data> -m <out> [--eval]
       [--using_depth --depth_loss_choice L1_loss] [--cull exact] ...

Trains on the card (``--data_device cuda``, the default) or, with
``--data_device cpu``, on the CPU with every kernel's plain version.  It
writes what the JAX CLI writes: ``cfg_args``, ``input.ply``,
``cameras.json``, ``train_log.jsonl``, ``point_cloud/iteration_<n>/
point_cloud.ply``, ``eval_log.jsonl`` at the test iterations and
``chkpnt<n>.npz`` at the checkpoint iterations.

Not ported yet, and refused before anything is written: the live-viewer
socket (pass ``--disable_gui_server``; ROADMAP Queue 1 item 8),
``--multihost`` and multi-device training (item 7) and the appearance
embedding (item 6).
"""
from __future__ import annotations

import json
import os
import sys
import uuid
from argparse import ArgumentParser, Namespace

import numpy as np


def prepare_output(args) -> str:
    """train.py:196-216: model dir + cfg_args replay file."""
    if not args.model_path:
        unique = os.getenv("OAR_JOB_ID") or str(uuid.uuid4())
        args.model_path = os.path.join("./output/", unique[0:10])
    print(f"Output folder: {args.model_path}")
    os.makedirs(args.model_path, exist_ok=True)
    ns = Namespace(**vars(args))
    with open(os.path.join(args.model_path, "cfg_args"), "w") as f:
        f.write(str(ns))
    return args.model_path


def build_parser():
    """The parser and its parameter groups (model, optimization, pipeline,
    performance): the JAX CLI's flags and defaults, but for the defaults
    ``config.py`` states."""
    from gsplat_tpu_torch.config import (ModelParams, OptimizationParams,
                                         PerformanceParams, PipelineParams)

    parser = ArgumentParser(description="Training script parameters")
    groups = (ModelParams(parser), OptimizationParams(parser),
              PipelineParams(parser), PerformanceParams(parser))
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[7_000, 30_000])
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--depth_loss_choice", type=str, default=None)
    parser.add_argument("--iterations_override", type=int, default=0)
    parser.add_argument("--disable_gui_server", action="store_true")
    parser.add_argument("--multihost", action="store_true",
                        help="multi-host training (not ported yet)")
    parser.add_argument("--coordinator_address", type=str, default=None)
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    return parser, groups


def main(argv=None):
    from gsplat_tpu_torch.config import OptimizationParams

    parser, (lp, op, pp, _) = build_parser()
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    if args.multihost:
        raise NotImplementedError(
            "--multihost: multi-host training is not ported yet; see "
            "ROADMAP.md, Queue 1 item 7")
    if not args.disable_gui_server:
        raise NotImplementedError(
            "the live-viewer socket server is not ported yet; pass "
            "--disable_gui_server (see ROADMAP.md, Queue 1 item 8)")
    args.save_iterations.append(args.iterations)

    dataset = lp.extract(args)
    opt = op.extract(args)
    pipe = pp.extract(args)
    # merge OptimizationParams defaults for fields argparse didn't see
    base_opt = OptimizationParams()
    for k, v in vars(base_opt).items():
        if not hasattr(opt, k):
            setattr(opt, k, v)
    if args.iterations_override:
        opt.iterations = args.iterations_override
        args.save_iterations = [i for i in args.save_iterations
                                if i <= opt.iterations] + [opt.iterations]

    import torch

    from gsplat_tpu_torch.device import resolve_device
    device = resolve_device(dataset.data_device)

    print("Optimizing " + args.model_path)
    prepare_output(args)
    if args.detect_anomaly:
        # reference: torch.autograd.set_detect_anomaly(args.detect_anomaly)
        # (train.py:302,324)
        torch.autograd.set_detect_anomaly(True)
        print("[debug] autograd anomaly detection enabled (--detect_anomaly)")

    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.train.trainer import Trainer

    capacity = args.capacity
    num_class = dataset.num_class if dataset.using_seg else 2
    gaussians = GaussianModel(dataset.sh_degree, num_class=num_class,
                              capacity=capacity or (1 << 18), device=device)
    dataset.model_path = args.model_path
    scene = Scene(dataset, gaussians,
                  lazy_images=getattr(args, "low_memory", False))
    if capacity == 0 and gaussians.num_alive * 16 > gaussians.capacity:
        # auto-grow so densification has headroom
        needed = 1 << int(np.ceil(np.log2(gaussians.num_alive * 16)))
        print(f"Auto-growing capacity to {needed}")
        gaussians = GaussianModel(dataset.sh_degree, num_class,
                                  capacity=needed, device=device)
        scene.gaussians = gaussians
        if scene.scene_info.point_cloud is not None:
            gaussians.create_from_pcd(scene.scene_info.point_cloud.points,
                                      scene.scene_info.point_cloud.colors,
                                      scene.cameras_extent)
    gaussians.training_setup()

    first_iter = 0
    if args.start_checkpoint:
        first_iter = gaussians.restore_checkpoint(args.start_checkpoint)
        print(f"Resumed from {args.start_checkpoint} at iteration {first_iter}")

    bg = np.ones(3) if dataset.white_background else np.zeros(3)
    trainer = Trainer(
        gaussians, scene, opt, bg=bg,
        depth_loss_choice=args.depth_loss_choice if dataset.using_depth else None,
        use_seg=dataset.using_seg, backend=args.backend,
        max_instances=args.max_instances, model_path=args.model_path,
        grad_precision=args.grad_precision,
        feat_precision=args.feat_precision,
        cull=args.cull,
        data_parallel=args.data_parallel,
        tile_parallel=args.tile_parallel,
        use_appearance=dataset.able_appearance_embedding,
        gt_cache=args.gt_cache,
        convert_shs_python=pipe.convert_SHs_python,
        compute_cov3d_python=pipe.compute_cov3D_python,
        debug_from=args.debug_from,
        vs_prune=args.vs_prune,
        white_background=dataset.white_background)

    metrics_log = open(os.path.join(args.model_path, "train_log.jsonl"), "a")

    def log_cb(it, metrics, tr):
        rec = {"iter": it, "loss": float(metrics["loss"]),
               "l1": float(metrics["l1"]),
               "n_visible": int(metrics["n_visible"]),
               "num_rendered": int(metrics["num_rendered"]),
               "n_alive": tr.model.num_alive}
        if bool(metrics["overflow"]):
            rec["overflow"] = True
        if tr.last_densify is not None and tr.last_densify["iter"] > it - 100:
            rec["densify"] = tr.last_densify
        metrics_log.write(json.dumps(rec) + "\n")
        metrics_log.flush()
        if it % 200 == 0:
            print(f"it {it}: loss {rec['loss']:.5f} l1 {rec['l1']:.5f} "
                  f"alive {rec['n_alive']}")

    elapsed = trainer.train(
        iterations=opt.iterations,
        test_iterations=set(args.test_iterations),
        save_iterations=set(args.save_iterations),
        checkpoint_iterations=set(args.checkpoint_iterations),
        callback=log_cb, first_iter=first_iter,
        profile_dir=args.profile_dir or None)
    metrics_log.close()
    print(f"\nTraining complete in {elapsed:.1f}s.")


if __name__ == "__main__":
    main()
