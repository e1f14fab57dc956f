"""Input/output transforms for DPT inference (PyTorch port's copy of
``gsplat_tpu/depth/transforms.py``; the port imports nothing of the JAX
package, so it keeps its own copy of this numpy and PIL module).

Spec: the reference DPT's transforms.py (Resize/NormalizeImage/
PrepareForNet) and util/io.py (read_image, write_depth).  numpy + PIL only
(no cv2); the network consumes NHWC float32, and every PNG this module
writes is the JAX module's, byte for byte.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image


def compute_resize(width: int, height: int, net_w: int, net_h: int,
                   multiple_of: int = 32, method: str = "minimal",
                   keep_aspect: bool = True):
    """Output (w, h) — transforms.py:93-151 'minimal' policy: scale as little
    as possible, snap to multiples of 32 by rounding."""
    scale_w = net_w / width
    scale_h = net_h / height
    if keep_aspect:
        if method == "minimal":
            if abs(1 - scale_w) < abs(1 - scale_h):
                scale_h = scale_w
            else:
                scale_w = scale_h
        elif method == "lower_bound":
            scale_h = scale_w = max(scale_w, scale_h)
        elif method == "upper_bound":
            scale_h = scale_w = min(scale_w, scale_h)
        else:
            raise ValueError(method)

    def snap(x, lo=None, hi=None):
        y = int(round(x / multiple_of) * multiple_of)
        if hi is not None and y > hi:
            y = int(np.floor(x / multiple_of) * multiple_of)
        if lo is not None and y < lo:
            y = int(np.ceil(x / multiple_of) * multiple_of)
        return y

    if method == "lower_bound":
        return snap(scale_w * width, lo=net_w), snap(scale_h * height, lo=net_h)
    if method == "upper_bound":
        return snap(scale_w * width, hi=net_w), snap(scale_h * height, hi=net_h)
    return snap(scale_w * width), snap(scale_h * height)


def read_image(path: str) -> np.ndarray:
    """RGB float [0,1] HWC (util/io.py:58-73)."""
    img = Image.open(path).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def prepare(img: np.ndarray, net_w: int = 384, net_h: int = 384,
            mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
            method: str = "minimal") -> np.ndarray:
    """Resize (keep aspect, multiple-of-32) + normalize. Returns [H,W,3]."""
    h, w = img.shape[:2]
    ow, oh = compute_resize(w, h, net_w, net_h, method=method)
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    pil = pil.resize((ow, oh), Image.BICUBIC)
    out = np.asarray(pil, dtype=np.float32) / 255.0
    return (out - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def write_depth(path_no_ext: str, depth: np.ndarray, bits: int = 2,
                absolute_depth: bool = False) -> str:
    """Min/max-normalized 8/16-bit PNG (util/io.py:171-198) — the format the
    dataset readers' depth/ folders consume."""
    if absolute_depth:
        out = depth
    else:
        dmin, dmax = float(depth.min()), float(depth.max())
        max_val = (1 << (8 * bits)) - 1
        if dmax - dmin > np.finfo(np.float32).eps:
            out = max_val * (depth - dmin) / (dmax - dmin)
        else:
            out = np.zeros_like(depth)
    path = path_no_ext + ".png"
    if bits == 1:
        Image.fromarray(out.astype(np.uint8)).save(path)
    else:
        arr = out.astype(np.uint16)
        Image.fromarray(arr, mode="I;16" if hasattr(Image, "new") else None
                        ).save(path)
    return path


def resize_prediction(pred: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Upsample the net-resolution prediction back to image size
    (run_monodepth.py:158-168 uses bicubic)."""
    im = Image.fromarray(pred.astype(np.float32), mode="F")
    return np.asarray(im.resize((out_w, out_h), Image.BICUBIC), np.float32)


def list_images(input_path: str):
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp"}
    names = [os.path.join(input_path, f) for f in sorted(os.listdir(input_path))
             if os.path.splitext(f)[1].lower() in exts]
    return names
