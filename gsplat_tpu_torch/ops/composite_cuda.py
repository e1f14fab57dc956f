"""Tiled forward compositor: kernel K1 (``csrc/composite_fwd.cu``).

PyTorch + CUDA port of ``gsplat_tpu/ops/composite_pallas.py::
composite_pallas`` (forward only) together with the forward half of
``segment_reduce.gather_rows``: the kernel reads each instance's
per-gaussian row straight from the [P, 6+C] attribute table, so the sorted
[I, 6+C] table the TPU path gathers is never built.

The per-pixel semantics are renderCUDA's (forward.cu:261-392), spelled out
in ops/composite_ref.py: power > 0 and alpha < 1/255 skip, alpha capped at
0.99, and a pixel stops at the first instance whose candidate transmittance
would drop below 1e-4 (that instance is not composited).
"""
from __future__ import annotations

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops.binning import BinningOut
from gsplat_tpu_torch.ops.composite_ref import ALPHA_MAX, ALPHA_MIN, T_EPS
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

TILE_PIX = TILE_X * TILE_Y
ATTR_BASE = 6      # table columns: mean x, mean y, conic a, b, c, opacity
CHUNK = 128        # instances per step of the plain version
LOG2E = 1.4426950408889634
_KERNEL_BATCH = 256                 # kBatch in composite_fwd.cu
_SMEM_LIMIT = 232448                # bytes of shared memory a CTA can use


def tile_ranges(bins: BinningOut):
    """Per-tile (start, count) clamped into the instance capacity.

    Under overflow, tile_start/tile_count describe instances that do not
    exist in the [I] arrays; unclamped, the kernel would read past them.
    Clamping keeps every read inside [0, I) (composite_pallas.py:750-769):
    the overflowed frame is wrong, which the overflow flag reports."""
    I = bins.gauss_id.shape[0]
    starts = torch.clamp(bins.tile_start, max=I)
    counts = torch.minimum(bins.tile_count, I - starts)
    return starts.to(torch.int32).contiguous(), counts.to(torch.int32).contiguous()


def pixel_coords(tiles, grid_x: int):
    """Pixel-center coordinates [n, TILE_PIX] of the given tiles."""
    lane = torch.arange(TILE_PIX, device=tiles.device)
    px = (tiles % grid_x)[:, None] * TILE_X + (lane % TILE_X)[None]
    py = (tiles // grid_x)[:, None] * TILE_Y + (lane // TILE_X)[None]
    return px.to(torch.float32), py.to(torch.float32)


def pair_power_alpha(rows, px, py):
    """``(power, alpha)`` [n, K, TILE_PIX] of K instance rows [n, K, 6+C]
    at the pixel centres ``px``, ``py`` [n, TILE_PIX], one rounding per
    operation.  An instance is skipped where ``power > 0`` or
    ``alpha < ALPHA_MIN``."""
    def col(j):
        return rows[:, :, j, None]                               # [n,K,1]

    dx = col(0) - px[:, None, :]                                 # [n,K,PIX]
    dy = col(1) - py[:, None, :]
    power = (-0.5 * (col(2) * dx * dx + col(4) * dy * dy)
             - col(3) * dx * dy)
    alpha = torch.clamp(col(5) * torch.exp2(power * LOG2E), max=ALPHA_MAX)
    return power, alpha


def composite_forward_plain(table, gauss_id, starts, counts, grid_x: int):
    """Plain PyTorch version of K1: the same recurrence, vectorized over a
    batch of tiles and a CHUNK of instances at a time (the chunk-level
    recurrence of composite_tiled.compute_tile_weights, carried across
    chunks, with no per-tile instance cap).  Returns the packed
    [T, C+2, TILE_PIX] output.  It rounds the transmittance like the kernel;
    only the channel sums are taken in another order."""
    dev = table.device
    P, R = table.shape
    C = R - ATTR_BASE
    I = gauss_id.shape[0]
    num_tiles = starts.shape[0]
    table_p = torch.cat([table, table.new_zeros((1, R))])    # sentinel row P
    out = torch.empty((num_tiles, C + 2, TILE_PIX), dtype=torch.float32,
                      device=dev)
    # tile batches keep each [tiles, CHUNK, TILE_PIX] temporary ~2^25 floats
    tb = max(1, (1 << 25) // (CHUNK * TILE_PIX))
    ks = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    for t0 in range(0, num_tiles, tb):
        t1 = min(num_tiles, t0 + tb)
        n = t1 - t0
        px, py = pixel_coords(torch.arange(t0, t1, device=dev), grid_x)
        st, cnt = starts[t0:t1], counts[t0:t1]
        Tc = torch.ones((n, TILE_PIX), dtype=torch.float32, device=dev)
        done = torch.zeros((n, TILE_PIX), dtype=torch.bool, device=dev)
        acc = torch.zeros((n, C, TILE_PIX), dtype=torch.float32, device=dev)
        last = torch.zeros((n, TILE_PIX), dtype=torch.int32, device=dev)
        for c0 in range(0, int(cnt.max()), CHUNK):
            if bool(done.all()):
                break
            pos = c0 + ks                                        # [K]
            valid = pos[None] < cnt[:, None]                     # [n,K]
            idx = torch.clamp(st[:, None] + pos[None], 0, max(I - 1, 0))
            gid = torch.where(valid, gauss_id[idx.long()], P)
            gid = torch.where((gid >= 0) & (gid < P), gid, P)
            valid = valid & (gid < P)
            rows = table_p[gid.long()]                           # [n,K,R]
            power, alpha = pair_power_alpha(rows, px, py)
            mask = (valid[:, :, None] & (power <= 0.0) & (alpha >= ALPHA_MIN)
                    & ~done[:, None, :])
            a = torch.where(mask, alpha, 0.0)
            # Transmittance as a running product that starts from the carried
            # T, so it is rounded exactly as the kernel's T *= (1 - alpha)
            # (a scan along a non-innermost dimension is sequential on both
            # the CPU and the card): the trigger decisions agree bit for bit.
            T_run = torch.cumprod(torch.cat([Tc[:, None, :], 1.0 - a], dim=1),
                                  dim=1)
            trigger = mask & (T_run[:, 1:] < T_EPS)
            contrib = mask & (torch.cumsum(trigger.to(torch.int32), 1) == 0)
            a_eff = torch.where(contrib, a, 0.0)
            T_run = torch.cumprod(
                torch.cat([Tc[:, None, :], 1.0 - a_eff], dim=1), dim=1)
            T_excl = T_run[:, :-1]
            w = a_eff * T_excl
            for c in range(C):
                acc[:, c] += torch.sum(w * rows[:, :, ATTR_BASE + c, None],
                                       dim=1)
            last = torch.maximum(last, torch.amax(
                torch.where(contrib, pos[None, :, None] + 1, 0), dim=1))
            done = done | trigger.any(dim=1)
            Tc = T_run[:, -1]
        out[t0:t1, :C] = acc
        out[t0:t1, C] = Tc
        out[t0:t1, C + 1] = last.to(torch.float32)
    return out


def composite_forward(table, gauss_id, starts, counts, grid_x: int):
    """K1 wrapper: packed [T, C+2, TILE_PIX] f32 (C composited channels,
    T_final, n_contrib) for the per-gaussian attribute ``table`` [P, 6+C]
    (mean2d, conic, opacity, features) and the sorted ``gauss_id`` [I] with
    per-tile ``starts``/``counts`` [T] (already clamped into [0, I)).
    A CPU tensor goes to ``composite_forward_plain``; a CUDA tensor
    launches ``csrc/composite_fwd.cu``."""
    dev = table.device
    req = _kernels.require
    req(table.dtype == torch.float32, f"table must be float32, got {table.dtype}")
    req(table.dim() == 2 and table.shape[1] > ATTR_BASE,
        f"table must be [P, 6+C] with C >= 1, got {tuple(table.shape)}")
    req(table.is_contiguous(), "table must be contiguous")
    num_tiles = starts.shape[0]
    _kernels.check_int32_vector("gauss_id", gauss_id, dev)
    _kernels.check_int32_vector("starts", starts, dev)
    _kernels.check_int32_vector("counts", counts, dev, num_tiles)
    req(grid_x > 0 and num_tiles % grid_x == 0,
        f"{num_tiles} tiles do not form rows of grid_x={grid_x}")
    if dev.type == "cpu":
        return composite_forward_plain(table, gauss_id, starts, counts, grid_x)
    req(dev.type == "cuda", f"unsupported device {dev}")
    P, R = table.shape
    C = R - ATTR_BASE
    req(TILE_PIX <= 1024, f"TILE_X*TILE_Y={TILE_PIX} exceeds 1024 threads")
    req(_KERNEL_BATCH * (R + 1) * 4 <= _SMEM_LIMIT,
        f"C={C} channels exceed the kernel's shared-memory batch")
    out = torch.empty((num_tiles, C + 2, TILE_PIX), dtype=torch.float32,
                      device=dev)
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        err = lib.gsplat_composite_forward(
            table.data_ptr(), P, C, gauss_id.data_ptr(), starts.data_ptr(),
            counts.data_ptr(), num_tiles, grid_x, TILE_X, TILE_Y,
            out.data_ptr(), _kernels.stream_of(table))
    _kernels.check(err, "composite_forward")
    _kernels.launch_counts["composite_forward"] += 1
    return out


def unpack_tiles(packed, C: int, width: int, height: int):
    """[T, C+2, TILE_PIX] -> ([C, H, W] channels, [H, W] T_final); n_contrib
    (row C+1) stays tile-packed for the training slice's backward."""
    grid_x = (width + TILE_X - 1) // TILE_X
    grid_y = (height + TILE_Y - 1) // TILE_Y
    full = packed[:, 0:C + 1].reshape(grid_y, grid_x, C + 1, TILE_Y, TILE_X)
    full = full.permute(2, 0, 3, 1, 4).reshape(
        C + 1, grid_y * TILE_Y, grid_x * TILE_X)[:, :height, :width]
    return full[:C], full[C]


def composite_cuda(means2d, conic, opacity, feats, bins: BinningOut,
                   width: int, height: int):
    """Tiled compositor: returns (img [C,H,W] pre-background, T_final [H,W],
    overflow []) through the K1 wrapper."""
    grid_x = (width + TILE_X - 1) // TILE_X
    C = feats.shape[1]
    table = torch.cat([means2d, conic, opacity[:, None], feats],
                      dim=1).to(torch.float32).contiguous()
    starts, counts = tile_ranges(bins)
    packed = composite_forward(table, bins.gauss_id.contiguous(), starts,
                               counts, grid_x)
    img, T_final = unpack_tiles(packed, C, width, height)
    return img, T_final, bins.overflow
