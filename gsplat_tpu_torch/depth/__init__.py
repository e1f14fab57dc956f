"""Monocular depth and segmentation estimation (DPT), the PyTorch port of
``gsplat_tpu/depth``: ViT backbones, reassemble and RefineNet-style fusion
decoder, monodepth and ADE20k segmentation heads, plain torch.  Weights
load from the official torch checkpoints via ``weights.load_torch``.
"""
from gsplat_tpu_torch.depth.dpt import (  # noqa: F401
    DPTConfig, dpt_config, dpt_forward, init_params,
)
