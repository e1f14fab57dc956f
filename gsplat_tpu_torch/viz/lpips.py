"""LPIPS perceptual metric (PyTorch port of ``gsplat_tpu/viz/lpips.py``;
reference lpipsPyTorch/).

The reference vendors a torch LPIPS whose backbone weights download from
torchvision at runtime (lpipsPyTorch/modules/networks.py: 'alex' default,
plus 'squeeze' and 'vgg') and ships it disabled in metrics.py:74-78.  With
no network, the three backbones are written here as plain ``F.conv2d`` /
``F.max_pool2d`` stacks (feature stack, unit-normalize, per-layer 1x1
linear weighting, spatial mean, summed over layers — modules/lpips.py) over
weights from a local .npz named by ``GSPLAT_LPIPS_WEIGHTS``
(``tools/convert_lpips_weights.py`` writes one from the official torch
checkpoints).  Without weights, constructing ``LPIPS`` raises, and the
metrics CLI reports SSIM and PSNR only, the reference's effective behavior.
The JAX module runs this network as plain XLA, so there is no kernel to
port.

Input convention: images in [0, 1], taken to [-1, 1] before the z-score
layer (the official LPIPS v0.1 ``normalize=True``), as in the JAX module.

On the card the convolutions run in cuDNN with TF32 off (a local
``torch.backends.cudnn.flags``; no global flag is touched): in TF32 the
score moves by about 1e-3 from the float32 one.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from gsplat_tpu_torch.device import resolve_device

VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512]
# conv counts after ReLUs 1_2, 2_2, 3_3, 4_3, 5_3 (lpips 'vgg')
SLICE_ENDS = (2, 4, 7, 10, 13)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _vgg_layers():
    """1-based torch-module list for torchvision vgg16.features."""
    out = []
    for c in VGG_CFG:
        if c == "M":
            out.append(("pool", (2, 2, False)))
        else:
            out.append(("conv", (c, 3, 1, 1)))
            out.append(("relu", None))
    return out


# layer descriptors: ("conv", (out_c, k, stride, pad)), ("relu", None),
# ("pool", (k, stride, ceil_mode)), ("fire", (squeeze_c, e1_c, e3_c)).
# ``targets`` are the reference's 1-based target_layers
# (lpipsPyTorch/modules/networks.py:69-97).
NET_SPECS = {
    "vgg": {
        "layers": _vgg_layers(),
        "targets": (4, 9, 16, 23, 30),
        "channels": (64, 128, 256, 512, 512),
    },
    "alex": {
        "layers": [
            ("conv", (64, 11, 4, 2)), ("relu", None),
            ("pool", (3, 2, False)),
            ("conv", (192, 5, 1, 2)), ("relu", None),
            ("pool", (3, 2, False)),
            ("conv", (384, 3, 1, 1)), ("relu", None),
            ("conv", (256, 3, 1, 1)), ("relu", None),
            ("conv", (256, 3, 1, 1)), ("relu", None),
            ("pool", (3, 2, False)),
        ],
        "targets": (2, 5, 8, 10, 12),
        "channels": (64, 192, 384, 256, 256),
    },
    "squeeze": {
        "layers": [
            ("conv", (64, 3, 2, 0)), ("relu", None),
            ("pool", (3, 2, True)),
            ("fire", (16, 64, 64)), ("fire", (16, 64, 64)),
            ("pool", (3, 2, True)),
            ("fire", (32, 128, 128)), ("fire", (32, 128, 128)),
            ("pool", (3, 2, True)),
            ("fire", (48, 192, 192)), ("fire", (48, 192, 192)),
            ("fire", (64, 256, 256)), ("fire", (64, 256, 256)),
        ],
        "targets": (2, 5, 8, 10, 11, 12, 13),
        "channels": (64, 128, 256, 384, 384, 512, 512),
    },
}


class LPIPS:
    """net_type: 'alex' (reference default, lpipsPyTorch/__init__.py:8),
    'vgg' or 'squeeze'.  None = take the net recorded in the weights file
    (legacy vgg-only files carry no tag and load as 'vgg').  The network
    runs on ``device`` ("cuda" by default)."""

    def __init__(self, weights_path: str | None = None,
                 net_type: str | None = None, device="cuda"):
        weights_path = weights_path or os.environ.get("GSPLAT_LPIPS_WEIGHTS")
        if not weights_path or not os.path.exists(weights_path):
            raise FileNotFoundError(
                "LPIPS needs pretrained backbone+linear weights (.npz from "
                "tools/convert_lpips_weights.py); set GSPLAT_LPIPS_WEIGHTS. "
                "Nothing is downloaded: like the reference, LPIPS stays "
                "disabled without local weights.")
        self.device = resolve_device(device)
        z = np.load(weights_path)
        file_net = str(z["net_type"]) if "net_type" in z else "vgg"
        self.net_type = net_type or file_net
        if self.net_type != file_net:
            raise ValueError(f"weights file is for net '{file_net}', "
                             f"requested '{self.net_type}'")
        spec = NET_SPECS[self.net_type]
        self.layers, self.targets = spec["layers"], set(spec["targets"])

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.params = []
        ci = fi = 0
        for kind, _ in self.layers:
            if kind == "conv":
                self.params.append((t(z[f"conv{ci}_w"]), t(z[f"conv{ci}_b"])))
                ci += 1
            elif kind == "fire":
                self.params.append(tuple(
                    t(z[f"fire{fi}_{part}"])
                    for part in ("squeeze_w", "squeeze_b", "e1_w", "e1_b",
                                 "e3_w", "e3_b")))
                fi += 1
            else:
                self.params.append(None)
        self.lins = [t(z[f"lin{j}_w"]).reshape(1, -1, 1, 1)
                     for j in range(len(spec["channels"]))]
        self.shift = t(_SHIFT).reshape(3, 1, 1)
        self.scale = t(_SCALE).reshape(3, 1, 1)

    def _features(self, x):
        """x: [3,H,W] in [0,1] -> feature maps at the target layers.  The
        layers after the last target are not run (alexnet's last pool,
        which a small image would pool to nothing)."""
        h = ((x * 2.0 - 1.0 - self.shift) / self.scale)[None]
        feats = []
        last = max(self.targets)
        for i, ((kind, arg), p) in enumerate(
                zip(self.layers[:last], self.params), start=1):
            if kind == "conv":
                _, _, s, pad = arg
                h = F.conv2d(h, p[0], p[1], stride=s, padding=pad)
            elif kind == "relu":
                h = F.relu(h)
            elif kind == "pool":
                k, s, ceil_mode = arg
                h = F.max_pool2d(h, k, s, ceil_mode=ceil_mode)
            elif kind == "fire":
                sw, sb, e1w, e1b, e3w, e3b = p
                sq = F.relu(F.conv2d(h, sw, sb))
                h = torch.cat([F.relu(F.conv2d(sq, e1w, e1b)),
                               F.relu(F.conv2d(sq, e3w, e3b, padding=1))],
                              dim=1)
            if i in self.targets:
                feats.append(h)
        return feats

    def _distance(self, a, b):
        total = torch.zeros((), device=self.device)
        for f1, f2, lin in zip(self._features(a), self._features(b),
                               self.lins):
            n1 = f1 / (torch.linalg.vector_norm(f1, dim=1, keepdim=True)
                       + 1e-10)
            n2 = f2 / (torch.linalg.vector_norm(f2, dim=1, keepdim=True)
                       + 1e-10)
            total = total + torch.mean(torch.sum((n1 - n2) ** 2 * lin, dim=1))
        return total

    def __call__(self, img_a, img_b) -> float:
        """LPIPS distance of two [3, H, W] images in [0, 1] (numpy arrays or
        tensors)."""
        a = torch.as_tensor(img_a, dtype=torch.float32, device=self.device)
        b = torch.as_tensor(img_b, dtype=torch.float32, device=self.device)
        with torch.no_grad(), torch.backends.cudnn.flags(
                enabled=True, allow_tf32=False):
            return float(self._distance(a, b))
