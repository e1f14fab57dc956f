"""Tiled compositor in plain torch (PyTorch port of
``gsplat_tpu/ops/composite_tiled.py``): the ``"jnp"`` and ``"reference"``
backends of ``ops/rasterize.py``.

Per tile: gather that tile's depth-sorted instance list, cut at ``k_max``
as the JAX path cuts it, compute the [TILE_PIX, K] alpha matrix, run the
front-to-back recurrence as cumulative products along K, and emit every
channel with one [TILE_PIX, K] x [K, C] product.  The rules are
renderCUDA's (forward.cu:261-392), as ``ops/composite_ref.py`` states
them: the power > 0 and alpha < 1/255 skips, alpha capped at 0.99, and
the pixel's termination when its transmittance would drop below 1e-4.

This is the JAX package's plain-XLA debug path, not a kernel: autograd
differentiates it.  Tiles go ``tile_batch`` at a time, as JAX's
``lax.map`` takes them, so memory holds one batch's [tile_batch,
TILE_PIX, k_max] blocks (128 MB a block at 32x32 tiles, k_max 1024 and a
batch of 32); under autograd each batch is recomputed in the backward
pass (``torch.utils.checkpoint``) rather than kept.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gsplat_tpu_torch.ops.binning import BinningOut
from gsplat_tpu_torch.ops.composite_ref import ALPHA_MAX, ALPHA_MIN, T_EPS
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

TILE_PIX = TILE_X * TILE_Y


def _pad_row(x):
    """Append one zero row so the sentinel index P is a safe gather target."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)


def compute_tile_weights(pix_xy, xy, conic, opac, valid):
    """The front-to-back recurrence of a tile, vectorized; any leading
    dimensions are a batch of tiles.

    Args:
      pix_xy: [..., TILE_PIX, 2] pixel centers of the tile.
      xy:     [..., K, 2] instance means (pixel coords), depth-sorted.
      conic:  [..., K, 3]; opac: [..., K]; valid: [..., K] bool.
    Returns (w [..., TILE_PIX, K] composite weights, T_final [..., TILE_PIX]).
    """
    dx = xy[..., None, :, 0] - pix_xy[..., :, 0:1]
    dy = xy[..., None, :, 1] - pix_xy[..., :, 1:2]
    power = (-0.5 * (conic[..., None, :, 0] * dx * dx
                     + conic[..., None, :, 2] * dy * dy)
             - conic[..., None, :, 1] * dx * dy)
    alpha = torch.clamp(opac[..., None, :] * torch.exp(power), max=ALPHA_MAX)
    mask = valid[..., None, :] & (power <= 0.0) & (alpha >= ALPHA_MIN)
    a = torch.where(mask, alpha, 0.0)

    # The candidate transmittance after instance i is the inclusive product
    # (masked entries are 1 - 0).  The pixel stops at the first instance
    # whose candidate drops below T_EPS, which is itself skipped
    # (forward.cu:351-358); up to that instance the plain product is exact.
    T_incl = torch.cumprod(1.0 - a, dim=-1)
    trigger = mask & (T_incl < T_EPS)
    done_incl = torch.cumsum(trigger.to(torch.int32), dim=-1) > 0
    contrib = mask & ~done_incl

    # T again with the instances after the stop removed (no division)
    a_eff = torch.where(contrib, a, 0.0)
    T_incl_eff = torch.cumprod(1.0 - a_eff, dim=-1)
    T_excl_eff = torch.cat([torch.ones_like(T_incl_eff[..., :1]),
                            T_incl_eff[..., :-1]], dim=-1)
    # T_final copied out: a view would keep the whole [.., TILE_PIX, K]
    # product alive beside the batch's result
    return a_eff * T_excl_eff, T_incl_eff[..., -1].clone()


def _tile_batch(tiles, m2d_p, con_p, op_p, ft_p, gauss_id, tile_start,
                tile_count, local_xy, grid_x: int, k_max: int):
    """([B, TILE_PIX, C] channels, [B, TILE_PIX] T_final) of the tiles
    ``tiles`` [B]."""
    I = gauss_id.shape[0]
    sentinel = m2d_p.shape[0] - 1
    ks = torch.arange(k_max, dtype=torch.int64, device=tiles.device)
    start = tile_start[tiles].to(torch.int64)
    count = torch.clamp(tile_count[tiles].to(torch.int64), max=k_max)
    idx = torch.clamp(start[:, None] + ks[None, :], 0, I - 1)
    valid = ks[None, :] < count[:, None]
    gid = torch.where(valid, gauss_id[idx].to(torch.int64), sentinel)

    origin = torch.stack([(tiles % grid_x) * TILE_X,
                          (tiles // grid_x) * TILE_Y], dim=-1).to(
        torch.float32)
    pix_xy = local_xy[None] + origin[:, None, :]
    w, T_final = compute_tile_weights(pix_xy, m2d_p[gid], con_p[gid],
                                      op_p[gid], valid)
    return torch.matmul(w, ft_p[gid]), T_final


def composite_tiled(means2d, conic, opacity, feats, binning: BinningOut,
                    width: int, height: int, k_max: int = 1024,
                    tile_batch: int = 32):
    """Returns (out [H, W, C] pre-background, T_final [H, W]),
    differentiable in means2d, conic, opacity and feats."""
    grid_x = (width + TILE_X - 1) // TILE_X
    grid_y = (height + TILE_Y - 1) // TILE_Y
    num_tiles = grid_x * grid_y
    C = feats.shape[1]
    dev = means2d.device

    inputs = [_pad_row(x) for x in (means2d, conic, opacity, feats)]
    tyy, txx = torch.meshgrid(
        torch.arange(TILE_Y, dtype=torch.float32, device=dev),
        torch.arange(TILE_X, dtype=torch.float32, device=dev), indexing="ij")
    local_xy = torch.stack([txx.reshape(-1), tyy.reshape(-1)], dim=-1)
    static = (binning.gauss_id, binning.tile_start, binning.tile_count,
              local_xy, grid_x, k_max)
    keep = not (torch.is_grad_enabled()
                and any(x.requires_grad for x in inputs))

    outs, Ts = [], []
    for b0 in range(0, num_tiles, tile_batch):
        tiles = torch.arange(b0, min(b0 + tile_batch, num_tiles),
                             dtype=torch.int64, device=dev)
        if keep:
            o, t = _tile_batch(tiles, *inputs, *static)
        else:
            o, t = checkpoint(_tile_batch, tiles, *inputs, *static,
                              use_reentrant=False)
        outs.append(o)
        Ts.append(t)
    outs = torch.cat(outs)
    Ts = torch.cat(Ts)

    # tile layout -> image, padding cropped
    img = outs.reshape(grid_y, grid_x, TILE_Y, TILE_X, C).permute(
        0, 2, 1, 3, 4).reshape(grid_y * TILE_Y, grid_x * TILE_X, C)
    Tf = Ts.reshape(grid_y, grid_x, TILE_Y, TILE_X).permute(
        0, 2, 1, 3).reshape(grid_y * TILE_Y, grid_x * TILE_X)
    return img[:height, :width], Tf[:height, :width]
