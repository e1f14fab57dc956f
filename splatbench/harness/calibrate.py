"""The readings that the limits of ``splatbench/checks/<cell>.json`` are set
from, on the card at the cell's own size:

    python3 -m splatbench.harness.calibrate --workload <cell> \\
        --seeds 1,2,3,... [--faults 3]

(a cell ``<config>.<traffic>`` that ``BENCHMARK.json`` does not list is
built from its files, on one chip).

For every seed, the program's sound run against the reference (the lower
readings; a training cell needs no measured window, a viewer cell renders
``sample_range`` frames).  On the first ``--faults`` seeds also the control,
the reference computed in bfloat16 and put in the program's place, and the
faults the cell can have (the upper readings):

- train: ``half_batch``, the loss over the image's top half alone, its mean
  over those rows; a state left unchanged reads 1 in ``change_gap`` and
  ``grad_gap`` by construction and needs no run;
- view: ``stale_frame``, each kept frame answered with the frame before it
  (another pose), and ``altered_bytes``, one 32x32 block of the frame's
  bytes inverted where ``frame_bytes`` made them.

One JSON line a reading goes to standard output."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from splatbench.harness import bench, check, spec, train, view
from splatbench.reference import camera, splat


OUT = sys.stdout
TRIMS = (1e-4, 1e-3)


def trimmed_gap(prog: dict, ref: dict, share: float) -> float:
    """``grad_gap`` over each leaf's rows outside the ``share`` of the
    reference's largest row norms (a look at what sets the gap)."""
    got, want = {}, {}
    for f, a, b in zip(splat.FIELDS, prog["grad_rows"], ref["grad_rows"]):
        r = b.reshape(b.shape[0], -1).double().norm(dim=1)
        keep = torch.ones_like(r, dtype=torch.bool)
        keep[torch.topk(r, int(share * r.shape[0])).indices] = False
        got[f] = float(torch.linalg.vector_norm(a[keep].double()))
        want[f] = float(torch.linalg.vector_norm(b[keep].double()))
    return check.norm_gap(got, want, ref["grad"])


def emit(cell, seed, kind, numbers, **extra):
    print(json.dumps(dict(cell=cell.name, seed=seed, kind=kind,
                          numbers=numbers, **extra)), file=OUT, flush=True)


def train_readings(ctx, seeds, n_faults):
    cfg = ctx.cell.config
    prep = train.prepare(ctx)
    H = cfg["height"]
    for k, seed in enumerate(seeds):
        t0 = time.perf_counter()
        r = train.start(ctx, prep, seed)
        del r["tr"], r["chunks"]
        ctx.free()
        args = (r["p0"], prep["views"], r["prog"]["views"], prep["tg"], cfg,
                ctx.cell.traffic, ctx.device)
        ref = train.reference_steps(*args, budget=ctx.budget)
        t_ref = time.perf_counter()
        emit(ctx.cell, seed, "sound", check.train_numbers(r["prog"], ref),
             trims={t: trimmed_gap(r["prog"], ref, t) for t in TRIMS},
             top_share=top_share(ref["grad_rows"]),
             losses=r["prog"]["losses"], ref_losses=ref["losses"],
             grad=r["prog"]["grad"], ref_grad=ref["grad"],
             change=r["prog"]["change"], ref_change=ref["change"],
             reference_s=t_ref - t0)
        if k < n_faults:
            ctl = train.reference_steps(*args, dtype=torch.bfloat16,
                                        budget=ctx.budget)
            emit(ctx.cell, seed, "control_bf16",
                 check.train_numbers(ctl, ref))
            half = train.reference_steps(*args, rows=slice(0, H // 2),
                                         budget=ctx.budget)
            emit(ctx.cell, seed, "half_batch", check.train_numbers(half, ref))
        del r
        ctx.free()


def top_share(rows, share: float = 1e-3) -> dict:
    """Per field, the share of the squared gradient norm that the
    ``share`` of rows with the largest gradients hold."""
    out = {}
    for f, x in zip(splat.FIELDS, rows):
        r = x.reshape(x.shape[0], -1).double().norm(dim=1) ** 2
        k = max(1, int(share * r.shape[0]))
        out[f] = float(torch.topk(r, k).values.sum() / r.sum().clamp_min(
            1e-300))
    return out


def pose_readings(ctx, prep):
    """Every pose once: its sound numbers (every seed's frames are these
    poses, so their worst is the worst any seed can read), and the
    gaussians whose tile rectangle or visibility differs between the port's
    preprocess and the reference's (the tile cull's edges, where rounding
    decides)."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    from gsplat_tpu_torch.viz import network_gui
    cfg, dev = ctx.cell.config, ctx.device
    W, H = cfg["width"], cfg["height"]
    p = prep["base"]
    for i, (cam, pose) in enumerate(zip(prep["cams"], prep["poses"])):
        out = renderer.render(cam, prep["model"], device=dev)
        b = network_gui.frame_bytes(out["render"])
        numbers = view.compare(ctx, prep, {0: (i, out["render"], b)})
        mats = [torch.as_tensor(m, device=dev)
                for m in camera.matrices(pose, W, H)]
        port = pre_lib.preprocess(
            p.xyz, torch.exp(p.scaling), p.rotation,
            torch.sigmoid(p.opacity[:, 0]), None, 0, *mats,
            cam.tan_fovx, cam.tan_fovy, W, H,
            colors_precomp=torch.zeros_like(p.xyz))
        ref = splat.preprocess(p, camera.cam(pose, W, H, dev),
                               cfg["sh_degree"])
        either = port.visible | ref.visible
        differ = either & ((port.visible != ref.visible)
                           | (port.rect_min.long() != ref.rect_min).any(1)
                           | (port.rect_max.long() != ref.rect_max).any(1))
        emit(ctx.cell, None, "pose", numbers, pose=i,
             rect_differs=int(differ.sum()), visible=int(either.sum()),
             bytes_over=int(round(numbers["byte_share"] * 3 * W * H)),
             pixels=pixels_over(ctx, prep, pose, out, b)
             if numbers["byte_share"] > 0 else [])


def pixels_over(ctx, prep, pose, out, frame, most: int = 8) -> list:
    """Up to ``most`` pixels whose bytes lie more than one level from the
    reference's: (x, y) and the program's and the reference's rgb, weight
    sum and depth there."""
    cfg, dev = ctx.cell.config, ctx.device
    W, H = cfg["width"], cfg["height"]
    ref = splat.render(prep["base"], camera.cam(pose, W, H, dev),
                       cfg["sh_degree"], torch.zeros(3, device=dev),
                       ctx.budget)
    got = np.frombuffer(frame, np.uint8).reshape(H, W, 3).astype(np.int16)
    bad = np.argwhere((np.abs(got - check.quantize(ref["image"])) > 1)
                      .any(-1))[:most]

    def at(t, y, x):
        return [round(float(v), 6) for v in t[..., y, x].reshape(-1)]
    return [dict(x=int(x), y=int(y), rgb=at(out["render"], y, x),
                 ref_rgb=at(ref["image"], y, x),
                 alpha=at(out["alpha"], y, x),
                 ref_alpha=at(ref["alpha"], y, x),
                 depth=at(out["depth_raw"], y, x),
                 ref_depth=at(ref["depth"], y, x)) for y, x in bad]


def view_readings(ctx, seeds, n_faults):
    cfg, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    prep = view.prepare(ctx)
    W, H = cfg["width"], cfg["height"]
    bg = torch.zeros(3, device=dev)
    pose_readings(ctx, prep)
    for k, seed in enumerate(seeds):
        f = view.frames(ctx, prep, seed, count=mix["sample_range"])
        emit(ctx.cell, seed, "sound",
             view.compare(ctx, prep, f["kept"]), failed=f["failed"])
        if k >= n_faults:
            continue
        ctl = {}
        for i, (pose, _, _) in f["kept"].items():
            img = splat.render(
                splat.Params(*[x.to(torch.bfloat16) for x in prep["base"]]),
                camera.cam(prep["poses"][pose], W, H, dev, torch.bfloat16),
                cfg["sh_degree"], bg.to(torch.bfloat16),
                ctx.budget)["image"].float()
            ctl[i] = (pose, img, check.quantize(img).tobytes())
        emit(ctx.cell, seed, "control_bf16", view.compare(ctx, prep, ctl))
        items = sorted(f["kept"].items())
        stale = {i: (pose, items[j - 1][1][1], items[j - 1][1][2])
                 for j, (i, (pose, _, _)) in enumerate(items) if j > 0}
        emit(ctx.cell, seed, "stale_frame", view.compare(ctx, prep, stale))
        emit(ctx.cell, seed, "altered_bytes",
             view.compare(ctx, prep, {i: (pose, img, alter(b, W, H))
                                      for i, (pose, img, b) in items}))


def alter(frame, width: int, height: int) -> bytes:
    """The frame's bytes with the 32x32 block at its centre inverted."""
    a = np.frombuffer(frame, np.uint8).reshape(height, width, 3).copy()
    y, x = height // 2 - 16, width // 2 - 16
    a[y:y + 32, x:x + 32] = 255 - a[y:y + 32, x:x + 32]
    return a.tobytes()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--set", action="append", default=[],
                    help="key=value: an optimization value of the mix, on "
                         "both sides (a look at what drives a reading)")
    ap.add_argument("--f32", action="store_true",
                    help="f32 gradient rows and features in place of the "
                         "configuration's bf16, in the program and the "
                         "reference (a second witness)")
    args = ap.parse_args(argv)
    global OUT
    OUT, sys.stdout = sys.stdout, sys.stderr
    listed = args.workload in spec.workloads()
    cell = spec.load(args.workload, workload=None if listed
                     else spec.unlisted(args.workload))
    for kv in args.set:
        k, v = kv.split("=")
        cell.traffic["optimization"][k] = float(v)
    if args.f32:
        cell.config["numerics"].update(grad_precision="f32",
                                       feat_precision="f32")
    os.environ["GSPLAT_TILE_X"] = os.environ["GSPLAT_TILE_Y"] = str(
        cell.config["tile"])
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    ctx = bench.Ctx(cell, seeds[0], 0.0, False, "cuda", time.perf_counter())
    readings = {"train": train_readings, "view": view_readings}
    readings[cell.traffic["kind"]](ctx, seeds, args.faults)
    return 0


if __name__ == "__main__":
    sys.exit(main())
