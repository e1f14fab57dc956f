"""Semantic segmentation inference CLI (PyTorch port of
``gsplat_tpu/scripts/run_segmentation.py``, the reference's
DPT/run_segmentation.py; ADE20k head):

    python -m gsplat_tpu_torch.scripts.run_segmentation -i <images> \\
        -o <segment> -m <weights.pt> [--num_classes N] [--data_device cpu]

writes per image a ``uint8`` class PNG (which segmentation training reads
from a scene's ``segment/`` folder) and ``<name>_overlay.png`` beside it.
The model runs on ``--data_device`` (``cuda`` by default; a stated
divergence, as in ``run_monodepth``).

Kept from the JAX CLI as they are: the overlay palette from
``np.random.default_rng(0)``; each class's logits resized bicubic to the
image, and the argmax taken over only the first ``min(C, 64)`` of them; a
random model (``torch.Generator`` seeded 0) with a warning where no
weights are given or found.
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-i", "--input_path", default="input")
    ap.add_argument("-o", "--output_path", default="output_semseg")
    ap.add_argument("-m", "--model_weights", default=None)
    ap.add_argument("-t", "--model_type", default="dpt_hybrid",
                    choices=["dpt_large", "dpt_hybrid"])
    ap.add_argument("--num_classes", type=int, default=150)
    ap.add_argument("--data_device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from PIL import Image

    from gsplat_tpu_torch.depth import transforms as T
    from gsplat_tpu_torch.depth.dpt import (dpt_config, dpt_forward,
                                            init_params)
    from gsplat_tpu_torch.depth.weights import load_torch
    from gsplat_tpu_torch.device import resolve_device

    device = resolve_device(args.data_device)
    cfg = dpt_config(args.model_type, head="segmentation",
                     num_classes=args.num_classes)
    if args.model_weights and os.path.exists(args.model_weights):
        model = load_torch(args.model_weights, cfg, device)
    else:
        print("WARNING: no weights — random init (shape check only)")
        model = init_params(cfg, torch.Generator().manual_seed(0),
                            device=device)

    os.makedirs(args.output_path, exist_ok=True)
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 255, (args.num_classes, 3)).astype(np.uint8)
    names = T.list_images(args.input_path)
    print(f"processing {len(names)} images on {device}")
    for idx, name in enumerate(names):
        img = T.read_image(name)
        inp = T.prepare(img, 384, 384)[None]
        logits = dpt_forward(model, inp)[0].cpu().numpy()      # [h,w,C]
        up = np.stack([T.resize_prediction(logits[..., c], img.shape[0],
                                           img.shape[1])
                       for c in range(min(logits.shape[-1], 64))], axis=-1)
        seg = np.argmax(up, axis=-1).astype(np.uint8)
        base = os.path.splitext(os.path.basename(name))[0]
        Image.fromarray(seg).save(os.path.join(args.output_path, base + ".png"))
        overlay = (0.5 * img * 255 + 0.5 * palette[seg]).astype(np.uint8)
        Image.fromarray(overlay).save(
            os.path.join(args.output_path, base + "_overlay.png"))
        print(f"  [{idx + 1}/{len(names)}] {name}")
    print("finished")


if __name__ == "__main__":
    main()
