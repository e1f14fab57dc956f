"""Monocular depth inference CLI (PyTorch port of
``gsplat_tpu/scripts/run_monodepth.py``, the reference's
DPT/run_monodepth.py:24-245):

    python -m gsplat_tpu_torch.scripts.run_monodepth -i <images> \\
        -o <depth> -m <weights.pt> -t dpt_hybrid [--data_device cpu]

writes min/max-normalized 16-bit PNG depth maps, one per image, which the
dataset readers take from a scene's ``depth/`` folder.  The model runs on
``--data_device`` (``cuda`` by default; ``cpu`` where the caller asks for
it), a stated divergence: the JAX CLI runs on JAX's default backend.

Kept from the JAX CLI as they are:
- ``--bf16`` changes nothing (the JAX CLI casts the input to float32 and
  leaves the params as they are);
- ``--kitti_crop`` cuts the 352x1216 window at the bottom centre;
- the KITTI and NYU models scale the prediction by 256 and 1000;
- with no weights given or found, a warning and a random model
  (``init_params`` from a ``torch.Generator`` seeded 0, where the JAX CLI
  draws from ``PRNGKey(0)``): a shape check only.  The repository holds
  no DPT weights; pass an official MiDaS/DPT ``.pt`` with ``-m``.
"""
from __future__ import annotations

import argparse
import os

MODEL_DEFAULTS = {
    "dpt_large": dict(net=(384, 384), scale=None),
    "dpt_hybrid": dict(net=(384, 384), scale=None),
    "dpt_hybrid_kitti": dict(net=(1216, 352), scale=256.0),
    "dpt_hybrid_nyu": dict(net=(640, 480), scale=1000.0),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input_path", default="input")
    ap.add_argument("-o", "--output_path", default="output_monodepth")
    ap.add_argument("-m", "--model_weights", default=None,
                    help="path to the official .pt checkpoint")
    ap.add_argument("-t", "--model_type", default="dpt_hybrid",
                    choices=sorted(MODEL_DEFAULTS))
    ap.add_argument("--absolute_depth", action="store_true")
    ap.add_argument("--kitti_crop", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="accepted as the JAX CLI does; changes nothing")
    ap.add_argument("--data_device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gsplat_tpu_torch.depth import transforms as T
    from gsplat_tpu_torch.depth.dpt import (dpt_config, dpt_forward,
                                            init_params)
    from gsplat_tpu_torch.depth.weights import load_torch
    from gsplat_tpu_torch.device import resolve_device

    device = resolve_device(args.data_device)
    cfg = dpt_config(args.model_type)
    md = MODEL_DEFAULTS[args.model_type]
    net_w, net_h = md["net"]

    if args.model_weights and os.path.exists(args.model_weights):
        model = load_torch(args.model_weights, cfg, device)
        print(f"loaded weights: {args.model_weights}")
    else:
        print("WARNING: no weights given/found — random init (shape check "
              "only; download the official MiDaS .pt for real output)")
        model = init_params(cfg, torch.Generator().manual_seed(0),
                            device=device)

    os.makedirs(args.output_path, exist_ok=True)
    names = T.list_images(args.input_path)
    print(f"processing {len(names)} images on {device}")
    for idx, name in enumerate(names):
        img = T.read_image(name)
        if args.kitti_crop:
            h, w, _ = img.shape
            top, left = h - 352, (w - 1216) // 2
            img = img[top:top + 352, left:left + 1216]
        inp = T.prepare(img, net_w, net_h)[None]
        if args.bf16:
            inp = inp.astype(np.float32)
        pred = dpt_forward(model, inp)[0].cpu().numpy()
        pred = T.resize_prediction(pred, img.shape[0], img.shape[1])
        if md["scale"]:
            pred = pred * md["scale"]
        base = os.path.splitext(os.path.basename(name))[0]
        out = T.write_depth(os.path.join(args.output_path, base), pred,
                            bits=2, absolute_depth=args.absolute_depth)
        print(f"  [{idx + 1}/{len(names)}] {name} -> {out}")
    print("finished")


if __name__ == "__main__":
    main()
