"""Top-level differentiable rasterizer: preprocess -> binning -> composite.

PyTorch port of ``gsplat_tpu/ops/rasterize.py``.  Channels are composited in
one pass: rgb (3) + depth (1) [+ segments (S)] + weight (1), or rgb alone
under ``render_only``.  Both packages bin identically for each backend.

Backends, wired as the JAX package wires them:

- ``"auto"`` and ``"pallas"``: binning pads every tile to 128 instances and
  the composite is one ``torch.autograd.Function`` (forward kernel K1,
  backward kernel K2, then the gather's adjoint with the segment-sum kernel
  K4).  ``grad_precision``, ``mxu_power`` and ``feat_precision`` select the
  forms of K1 and K2 and of the reduction around K4 as in the JAX
  package's Pallas path (``ops/composite_cuda.py``).  On a CUDA tensor the
  kernels launch or raise; on a CPU tensor their plain versions run.  One
  divergence: on the CPU the JAX package's ``"auto"`` becomes ``"jnp"``
  (its ``rasterize.py:79``), the port's is K1's plain version.
- ``"jnp"`` and ``"reference"``: binning with no pads and the plain-torch
  tiled compositor (``ops/composite_tiled.py``, autograd), each tile's list
  cut at ``k_max``, ``tile_batch`` tiles at a time.  The JAX package sends
  both names down that one path (its ``rasterize.py:130, 151-170``); the
  precision and power options do not apply there.  A caller asks for them
  by name: ``"auto"`` never falls back to them.

Preprocess and the background term are plain autograd.  Binning is index
bookkeeping and sees detached inputs.  The three stages run in the spans
``rasterize.preprocess``, ``rasterize.binning`` and ``rasterize.composite``
(``tracing.py``); the composite's backward runs in ``composite.backward``.

``means2d_offset`` is the gradient tap that stands in for the reference's
``screenspace_points``: pass zeros [P,2] that require grad; its gradient is
the pixel-space dL/d(mean2d).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from gsplat_tpu_torch import tracing
from gsplat_tpu_torch.device import check_on, resolve_device
from gsplat_tpu_torch.ops import binning as binning_lib
from gsplat_tpu_torch.ops import composite_tiled as tiled_lib
from gsplat_tpu_torch.ops import preprocess as pre_lib
from gsplat_tpu_torch.ops.composite_cuda import composite_cuda
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

ALIGN = 128   # per-tile segment alignment (the JAX Pallas path's CHUNK)
TILED_BACKENDS = ("jnp", "reference")            # ops/composite_tiled.py
BACKENDS = ("auto", "pallas") + TILED_BACKENDS   # the first two: K1


@dataclass(frozen=True)
class RasterizeConfig:
    """Rasterizer configuration (the JAX package's fields)."""
    width: int
    height: int
    sh_degree: int = 3
    num_class: int = 0              # segment channels composited (0 = off)
    max_instances: int = 1 << 20    # tile-instance capacity (binning)
    k_max: int = 1024               # per-tile instance cap (tiled path)
    tile_batch: int = 32            # tiles per step (tiled path)
    backend: str = "auto"           # "auto" | "pallas": kernel K1 (its
                                    # plain version on CPU tensors);
                                    # "jnp" | "reference": composite_tiled
    grad_precision: str = "f32"     # "bf16": per-instance grad rows
                                    # rounded to bf16 before the f32 sum
    cull: str = "none"              # "exact": drop instances whose ellipse
                                    # misses the tile (extras form of K3)
    max_rows: int = 0               # row capacity for cull="exact"
                                    # (0 = max_instances // 2)
    full_width: int = 0             # crop rendering: dims of the FULL camera
    full_height: int = 0            # (0 = width/height), with pixel_offset
    render_only: bool = False       # rgb only; alpha = 1 - T_final
    mxu_power: bool = False         # power from tile-relative
                                    # coefficients, power cut 1e-4
    feat_precision: str = "f32"     # "bf16": features as bf16 pairs

    @property
    def grid_x(self):
        return (self.width + TILE_X - 1) // TILE_X

    @property
    def grid_y(self):
        return (self.height + TILE_Y - 1) // TILE_Y


def _check_config(config: RasterizeConfig):
    if config.backend not in BACKENDS:
        raise ValueError(f"backend={config.backend!r}: expected one of "
                         f"{BACKENDS}")
    for name in ("grad_precision", "feat_precision"):
        value = getattr(config, name)
        if value not in ("f32", "bf16"):
            raise ValueError(f"RasterizeConfig.{name} must be 'f32' or "
                             f"'bf16', got {value!r}")


def rasterize(
    config: RasterizeConfig,
    means3d: torch.Tensor,                 # [P,3]
    scales: torch.Tensor,                  # [P,3] activated
    rotations: torch.Tensor,               # [P,4]
    opacities: torch.Tensor,               # [P] activated
    shs: Optional[torch.Tensor],           # [P,K,3]
    viewmatrix,
    projmatrix,
    campos,
    tan_fovx,
    tan_fovy,
    bg,                                    # [3]
    segments: Optional[torch.Tensor] = None,       # [P,S] activated probs
    means2d_offset: Optional[torch.Tensor] = None,  # [P,2]
    scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    clamp_tan_fovx=None,
    clamp_tan_fovy=None,
    pixel_offset=(0, 0),
    device="cuda",
):
    """Returns dict(render [3,H,W], depth [H,W], alpha [H,W],
    segment [S,H,W]?, radii [P], visibility [P] bool, overflow [],
    num_rendered [], num_padded [], T_final [H,W]).

    Tensors must lie on ``device``; camera matrices, ``campos`` and ``bg``
    may be numpy arrays and are moved there."""
    dev = resolve_device(device)
    _check_config(config)
    tensors = dict(means3d=means3d, scales=scales, rotations=rotations,
                   opacities=opacities, shs=shs, segments=segments,
                   means2d_offset=means2d_offset,
                   colors_precomp=colors_precomp, cov3d_precomp=cov3d_precomp)
    check_on(dev, **tensors)

    def on_dev(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    with tracing.span("rasterize.preprocess"):
        pre = pre_lib.preprocess(
            means3d, scales, rotations, opacities, shs,
            config.sh_degree, on_dev(viewmatrix), on_dev(projmatrix),
            on_dev(campos), tan_fovx, tan_fovy, config.width, config.height,
            scale_modifier=scale_modifier,
            cov3d_precomp=cov3d_precomp,
            colors_precomp=colors_precomp,
            clamp_tan_fovx=clamp_tan_fovx,
            clamp_tan_fovy=clamp_tan_fovy,
            full_width=config.full_width or None,
            full_height=config.full_height or None,
            pixel_offset=pixel_offset,
        )
        if means2d_offset is not None:
            pre = pre._replace(means2d=pre.means2d + means2d_offset)

    # binning is index bookkeeping: no gradient flows through it; the
    # tiled path takes no pads
    tiled = config.backend in TILED_BACKENDS
    with tracing.span("rasterize.binning"):
        bins = binning_lib.bin_gaussians(
            pre_lib.PreprocessOut(*[x.detach() for x in pre]),
            config.grid_x, config.grid_y, config.max_instances,
            align=1 if tiled else ALIGN, cull=config.cull,
            max_rows=config.max_rows)

    with tracing.span("rasterize.composite"):
        if config.render_only:
            feats = pre.rgb
        else:
            # the constant weight/ones column sits last, so the compositor
            # can leave it out of the backward (const_last_feat)
            feats = [pre.rgb, pre.depths[:, None]]
            if config.num_class > 0:
                if segments is None:
                    raise ValueError("num_class > 0 needs segments")
                feats.append(segments)
            feats.append(torch.ones_like(pre.depths[:, None]))
            feats = torch.cat(feats, dim=1)

        if tiled:
            img, T_final = tiled_lib.composite_tiled(
                pre.means2d, pre.conic, pre.opacity, feats, bins,
                config.width, config.height, k_max=config.k_max,
                tile_batch=config.tile_batch)
            chw, overflow = img.permute(2, 0, 1), bins.overflow
        else:
            chw, T_final, overflow = composite_cuda(
                pre.means2d, pre.conic, pre.opacity, feats, bins,
                config.width, config.height,
                const_last_feat=not config.render_only,
                grad_precision=config.grad_precision,
                mxu_power=config.mxu_power,
                feat_precision=config.feat_precision)

        render = chw[0:3] + T_final[None] * on_dev(bg)[:, None, None]
    out = {
        "render": render,
        "radii": pre.radii,
        "visibility": pre.visible,
        "overflow": overflow,
        "num_rendered": bins.num_rendered,
        "num_padded": bins.num_padded,
        "T_final": T_final,
    }
    if config.render_only:
        out["alpha"] = 1.0 - T_final
        return out
    out["depth"] = chw[3]
    out["alpha"] = chw[4 + config.num_class]
    if config.num_class > 0:
        out["segment"] = chw[4:4 + config.num_class]
    return out
