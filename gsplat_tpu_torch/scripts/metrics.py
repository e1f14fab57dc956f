"""Metrics CLI (PyTorch port of ``gsplat_tpu/scripts/metrics.py``, mirror of
reference metrics.py:24-103).

python -m gsplat_tpu_torch.scripts.metrics -m <model> [<model> ...]
    [--split test] [--data_device cpu]

Computes SSIM and PSNR (``train/losses.py``), and LPIPS where
``GSPLAT_LPIPS_WEIGHTS`` names a local npz (the reference ships LPIPS wired
but disabled, metrics.py:74-78), over ``<model>/<split>/ours_<iter>/
{renders,gt}``, and writes ``results.json`` and ``per_view.json`` with the
JAX CLI's keys.  Scores on ``--data_device``: ``cuda`` by default, ``cpu``
where the caller asks for it.
"""
from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from pathlib import Path

import numpy as np


def read_images(renders_dir, gt_dir):
    from PIL import Image

    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        r = np.asarray(Image.open(os.path.join(renders_dir, fname)),
                       np.float32) / 255.0
        g = np.asarray(Image.open(os.path.join(gt_dir, fname)),
                       np.float32) / 255.0
        renders.append(r[..., :3].transpose(2, 0, 1))
        gts.append(g[..., :3].transpose(2, 0, 1))
        names.append(fname)
    return renders, gts, names


def try_lpips(device="cuda"):
    """The LPIPS module, or None (with the reason printed) when it cannot be
    built, as in the JAX CLI: no local weights named, or a file made for
    another net (the reference's disabled-LPIPS behavior)."""
    try:
        from gsplat_tpu_torch.viz.lpips import LPIPS
        return LPIPS(device=device)
    except Exception as e:  # noqa: BLE001
        print(f"[metrics] LPIPS unavailable ({e}); reporting SSIM/PSNR only")
        return None


def evaluate(model_paths, split="test", device="cuda"):
    import torch

    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.train import losses as L

    dev = resolve_device(device)
    full_dict = {}
    per_view_dict = {}
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict[scene_dir] = {}
        per_view_dict[scene_dir] = {}
        test_dir = Path(scene_dir) / split
        lp = try_lpips(dev)
        for method in sorted(os.listdir(test_dir)):
            print("Method:", method)
            method_dir = test_dir / method
            renders, gts, names = read_images(method_dir / "renders",
                                              method_dir / "gt")
            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rt = torch.from_numpy(r).to(dev)
                gt = torch.from_numpy(g).to(dev)
                ssims.append(float(L.ssim(rt, gt)))
                psnrs.append(float(L.psnr(rt, gt)))
                if lp is not None:
                    lpipss.append(lp(rt, gt))
            print(f"  SSIM : {np.mean(ssims):>12.7f}")
            print(f"  PSNR : {np.mean(psnrs):>12.7f}")
            if lpipss:
                print(f"  LPIPS: {np.mean(lpipss):>12.7f}")
            full_dict[scene_dir][method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                **({"LPIPS": float(np.mean(lpipss))} if lpipss else {}),
            }
            per_view_dict[scene_dir][method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
            }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict[scene_dir], f, indent=2)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict[scene_dir], f, indent=2)
    return full_dict


def main(argv=None):
    parser = ArgumentParser(description="Training script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str)
    parser.add_argument("--split", default="test", type=str)
    parser.add_argument("--data_device", default="cuda", type=str)
    args = parser.parse_args(argv)
    evaluate(args.model_paths, args.split, args.data_device)


if __name__ == "__main__":
    main()
