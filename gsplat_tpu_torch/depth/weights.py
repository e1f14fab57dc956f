"""Official DPT torch checkpoint -> the port's DPT model (port of
``gsplat_tpu/depth/weights.py``).

The public MiDaS/DPT weights (e.g. dpt_hybrid-midas-501f0c75.pt,
dpt_large-midas-2f21e586.pt) are plain ``torch.save``d state dicts with
timm vision-transformer naming.  The port's modules carry those names
(``depth/dpt.py``), so no transpose is needed: the model takes exactly the
keys that the JAX ``convert_state_dict`` (weights.py:115-160) reads, a
missing one raises ``KeyError`` as the JAX dict lookup does, and keys the
JAX converter ignores (a timm ViT's ``norm.*`` and ``head.*``, the
segmentation model's ``auxlayer.*``, BatchNorm's ``num_batches_tracked``)
are ignored here too.  The repository holds no DPT weights.
"""
from __future__ import annotations

import torch

from gsplat_tpu_torch.depth.dpt import DPT, DPTConfig, from_state_dict
from gsplat_tpu_torch.device import resolve_device


def load_torch(path: str, cfg: DPTConfig, device="cuda") -> DPT:
    """Load an official .pt checkpoint into a model on ``device``, in eval
    mode (weights.py:163-170: ``state_dict`` unwrapped, ``attn_mask`` keys
    dropped)."""
    dev = resolve_device(device)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if "attn_mask" not in k}
    return from_state_dict(sd, cfg, dev)
