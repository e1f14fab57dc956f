"""Naive reference compositor — the oracle for the tiled kernel (PyTorch
port of ``gsplat_tpu/ops/composite_ref.py``).

Composites ALL gaussians over ALL pixels in depth order, O(P * H * W), so it
is for small test sizes only.  It reproduces the CUDA per-pixel loop
(renderCUDA, forward.cu:261-392):

- front-to-back order by view depth
- a gaussian touches a pixel only if the pixel's tile lies inside the
  gaussian's tile rect (what binning enforces in the real path)
- skip if power > 0, skip if alpha < 1/255, alpha capped at 0.99
- a pixel terminates when the *candidate* transmittance would drop below
  1e-4; the triggering gaussian itself is not composited
- out_color = C + T_final * bg; alpha output is the accumulated weight sum
"""
from __future__ import annotations

from typing import Optional

import torch

from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y, PreprocessOut

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4


def composite_reference(
    pre: PreprocessOut,
    width: int,
    height: int,
    bg: torch.Tensor,                              # [3]
    depths_feat: Optional[torch.Tensor] = None,    # [P] composited as depth
    segments: Optional[torch.Tensor] = None,       # [P, S] activated probs
):
    dev = pre.depths.device
    order = torch.argsort(pre.depths, stable=True)
    dfeat = pre.depths if depths_feat is None else depths_feat
    S = 0 if segments is None else segments.shape[1]

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    tile_x = (xs / TILE_X).to(torch.int32)
    tile_y = (ys / TILE_Y).to(torch.int32)

    T = torch.ones((height, width), dtype=torch.float32, device=dev)
    done = torch.zeros((height, width), dtype=torch.bool, device=dev)
    C = torch.zeros((height, width, 3), dtype=torch.float32, device=dev)
    D = torch.zeros((height, width), dtype=torch.float32, device=dev)
    A = torch.zeros((height, width), dtype=torch.float32, device=dev)
    Sacc = torch.zeros((height, width, max(S, 1)), dtype=torch.float32,
                       device=dev)
    for g in order.tolist():
        if not bool(pre.visible[g]):
            continue
        rmin, rmax = pre.rect_min[g], pre.rect_max[g]
        covered = ((tile_x >= rmin[0]) & (tile_x < rmax[0])
                   & (tile_y >= rmin[1]) & (tile_y < rmax[1]))
        con = pre.conic[g]
        dx = pre.means2d[g, 0] - xs
        dy = pre.means2d[g, 1] - ys
        power = -0.5 * (con[0] * dx * dx + con[2] * dy * dy) - con[1] * dx * dy
        alpha = torch.clamp(pre.opacity[g] * torch.exp(power), max=ALPHA_MAX)
        mask = covered & (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done
        test_T = T * (1.0 - alpha)
        trigger = mask & (test_T < T_EPS)
        contrib = mask & ~trigger
        w = torch.where(contrib, alpha * T, 0.0)
        C = C + w[..., None] * pre.rgb[g]
        D = D + w * dfeat[g]
        A = A + w
        if S:
            Sacc = Sacc + w[..., None] * segments[g]
        T = torch.where(contrib, test_T, T)
        done = done | trigger

    out = {
        "render": (C + T[..., None] * bg).permute(2, 0, 1),  # [3,H,W]
        "depth": D,                                           # [H,W]
        "alpha": A,                                           # [H,W]
        "T_final": T,
    }
    if S:
        out["segment"] = Sacc.permute(2, 0, 1)                # [S,H,W]
    return out
