"""Mean squared distance to the 3 nearest neighbours: gaussian scale init.

PyTorch port of ``gsplat_tpu/ops/knn.py``.  Behavioral spec: reference
simple-knn (simple_knn.cu:185-221 / spatial.cu:15-26, used in
scene/gaussian_model.py:143-144).  The CUDA version is itself an
approximation (Morton sort + box-pruned candidate search), so the parity
target is "mean of 3-NN squared distances".

As in the JAX package: Morton-sort the points, then take candidates from a
window of +-W neighbours in Morton order via ``torch.roll``, fully
vectorized, no data-dependent shapes.  For W=32 this matches brute force on
typical SfM clouds to well under 1%.
"""
from __future__ import annotations

import torch


def _expand_bits_10(v):
    """Spread 10 bits to every 3rd position (simple_knn.cu:45-57
    prepMorton), on int64 words masked to 32 bits."""
    m = 0xFFFFFFFF
    v = ((v * 0x00010001) & m) & 0xFF0000FF
    v = ((v * 0x00000101) & m) & 0x0F00F00F
    v = ((v * 0x00000011) & m) & 0xC30C30C3
    v = ((v * 0x00000005) & m) & 0x49249249
    return v


def morton_codes(points):
    """30-bit Morton codes (int64) from min-max normalized coords
    (simple_knn.cu:59-70)."""
    mn = torch.min(points, dim=0).values
    mx = torch.max(points, dim=0).values
    scale = 1023.0 / torch.clamp(mx - mn, min=1e-12)
    q = torch.clamp((points - mn) * scale, 0, 1023).to(torch.int64)
    x = _expand_bits_10(q[:, 0])
    y = _expand_bits_10(q[:, 1])
    z = _expand_bits_10(q[:, 2])
    return x | (y << 1) | (z << 2)


def dist2_knn(points: torch.Tensor, window: int = 32, k: int = 3):
    """Mean of squared distances to the k nearest neighbours per point.

    Args: points [P,3] fp32. Returns [P] fp32."""
    P = points.shape[0]
    dev = points.device
    codes = morton_codes(points)
    order = torch.argsort(codes, stable=True)
    inv_order = torch.argsort(order, stable=True)
    sp = points[order]  # [P,3] morton-sorted

    best = torch.full((P, k), float("inf"), dtype=torch.float32, device=dev)
    pos = torch.arange(P, device=dev)
    for o in range(-window, window + 1):
        if o == 0:
            continue
        nb = torch.roll(sp, -o, dims=0)
        d2 = torch.sum((sp - nb) ** 2, dim=-1)
        # mask wrapped candidates (they would duplicate in-range neighbours)
        in_range = (pos + o >= 0) & (pos + o < P)
        d2 = torch.where(in_range, d2, float("inf"))
        worst = best[:, -1]
        cand = torch.where(d2 < worst, d2, worst)
        best = torch.sort(torch.cat([best[:, :-1], cand[:, None]], dim=1),
                          dim=1).values
    return torch.mean(best, dim=1)[inv_order]
