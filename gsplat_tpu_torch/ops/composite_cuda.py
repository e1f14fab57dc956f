"""Tiled compositor: the forward kernel K1 (``csrc/composite_fwd.cu``) and
the backward kernel K2 (``csrc/composite_bwd.cu``) under one
``torch.autograd.Function``.

PyTorch + CUDA port of ``gsplat_tpu/ops/composite_pallas.py::
composite_pallas`` together with ``segment_reduce.gather_rows``: K1 reads
each instance's per-gaussian row straight from the [P, 6+C] attribute table,
so the sorted [I, 6+C] table the TPU path gathers is never built.  The
backward runs K2, which leaves one gradient row per instance, and then the
gather's adjoint (a sort of the gaussian ids plus the segment-sum kernel K4,
``ops/segment_reduce.py``).

The per-pixel semantics are renderCUDA's (forward.cu:261-392), spelled out
in ops/composite_ref.py: power > 0 and alpha < 1/255 skip, alpha capped at
0.99, and a pixel stops at the first instance whose candidate transmittance
would drop below 1e-4 (that instance is not composited).  Under
differentiation the 0.99 cap is a true ``min`` (no gradient through a capped
alpha), the JAX package's deliberate deviation from backward.cu.
"""
from __future__ import annotations

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import segment_reduce
from gsplat_tpu_torch.ops.binning import BinningOut
from gsplat_tpu_torch.ops.composite_ref import ALPHA_MAX, ALPHA_MIN, T_EPS
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

TILE_PIX = TILE_X * TILE_Y
ATTR_BASE = 6      # table columns: mean x, mean y, conic a, b, c, opacity
CHUNK = 128        # instances per step of the plain version
LOG2E = 1.4426950408889634
_KERNEL_BATCH = 256                 # kFwdBatch in composite_fwd.cuh
_MAX_THREADS = 1024                 # one thread per tile pixel in K1 and K2
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


def pair_terms(rows, px, py):
    """``(dx, dy, power, raw)`` [n, K, TILE_PIX] of K instance rows
    [n, K, 6+C] at the pixel centres ``px``, ``py`` [n, TILE_PIX], one
    rounding per operation; ``raw`` is opacity * G before the 0.99 cap."""
    def col(j):
        return rows[:, :, j, None]                               # [n,K,1]

    dx = col(0) - px[:, None, :]                                 # [n,K,PIX]
    dy = col(1) - py[:, None, :]
    power = (-0.5 * (col(2) * dx * dx + col(4) * dy * dy)
             - col(3) * dx * dy)
    return dx, dy, power, col(5) * torch.exp2(power * LOG2E)


def pair_power_alpha(rows, px, py):
    """``(power, alpha)`` of ``pair_terms``' pairs.  An instance is skipped
    where ``power > 0`` or ``alpha < ALPHA_MIN``."""
    _, _, power, raw = pair_terms(rows, px, py)
    return power, torch.clamp(raw, max=ALPHA_MAX)


def _instance_rows(table_p, gauss_id, st, cnt, pos, P: int):
    """Rows [n, K, 6+C] of the chunk positions ``pos`` [K] of the tiles with
    ranges ``st``, ``cnt`` [n], from the table with its sentinel row P;
    also ``valid`` [n, K] (a real instance of the tile) and the slot index
    ``idx`` [n, K] clamped into the instance capacity."""
    I = gauss_id.shape[0]
    valid = pos[None] < cnt[:, None]
    idx = torch.clamp(st[:, None] + pos[None], 0, max(I - 1, 0)).long()
    gid = torch.where(valid, gauss_id[idx], P)
    gid = torch.where((gid >= 0) & (gid < P), gid, P)
    return table_p[gid.long()], valid & (gid < P), idx


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
            rows, valid, _ = _instance_rows(table_p, gauss_id, st, cnt, pos,
                                            P)                   # [n,K,R]
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


def _check_tile_inputs(table, gauss_id, starts, counts, grid_x: int):
    """What K1 and K2 both take: the table, the sorted ids, the ranges."""
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


def _check_backward_inputs(table, gauss_id, starts, counts, grid_x: int,
                           packed, d_packed, Cg: int):
    """What K2 takes beyond K1's inputs: ``Cg`` and the two packed arrays."""
    req = _kernels.require
    _check_tile_inputs(table, gauss_id, starts, counts, grid_x)
    num_tiles = starts.shape[0]
    C = table.shape[1] - ATTR_BASE
    req(0 <= Cg <= C, f"Cg={Cg} outside [0, C={C}]")
    for name, t in (("packed", packed), ("d_packed", d_packed)):
        req(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        req(t.shape == (num_tiles, C + 2, TILE_PIX),
            f"{name} must be [{num_tiles}, {C + 2}, {TILE_PIX}], got "
            f"{tuple(t.shape)}")
        req(t.is_contiguous(), f"{name} must be contiguous")
        req(t.device == table.device,
            f"{name} is on {t.device}, expected {table.device}")


def composite_forward(table, gauss_id, starts, counts, grid_x: int):
    """K1 wrapper: packed [T, C+2, TILE_PIX] f32 (C composited channels,
    T_final, n_contrib) for the per-gaussian attribute ``table`` [P, 6+C]
    (mean2d, conic, opacity, features) and the sorted ``gauss_id`` [I] with
    per-tile ``starts``/``counts`` [T] (already clamped into [0, I)).
    A CPU tensor goes to ``composite_forward_plain``; a CUDA tensor
    launches ``csrc/composite_fwd.cu``."""
    dev = table.device
    req = _kernels.require
    _check_tile_inputs(table, gauss_id, starts, counts, grid_x)
    num_tiles = starts.shape[0]
    if dev.type == "cpu":
        return composite_forward_plain(table, gauss_id, starts, counts, grid_x)
    req(dev.type == "cuda", f"unsupported device {dev}")
    P, R = table.shape
    C = R - ATTR_BASE
    req(TILE_PIX <= _MAX_THREADS,
        f"TILE_X*TILE_Y={TILE_PIX} exceeds {_MAX_THREADS} threads")
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


def composite_backward_plain(table, gauss_id, starts, counts, grid_x: int,
                             packed, d_packed, Cg: int):
    """Plain PyTorch version of K2: the same forward walk as
    ``composite_forward_plain`` (tile batches, CHUNK instances at a time,
    transmittance and the prefix of w*g carried across chunks), gated by
    K1's ``n_contrib``.  Returns the per-instance gradient rows
    [I, 6+Cg]: d mean2d, d conic, d opacity, d of the first Cg features;
    rows of slots no tile owns, and of instances past a tile's last
    contributor, are zero."""
    dev = table.device
    P, R = table.shape
    C = R - ATTR_BASE
    I = gauss_id.shape[0]
    num_tiles = starts.shape[0]
    table_p = torch.cat([table, table.new_zeros((1, R))])    # sentinel row P
    out = torch.zeros((I, ATTR_BASE + Cg), dtype=torch.float32, device=dev)
    tb = max(1, (1 << 25) // (CHUNK * TILE_PIX))
    ks = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    for t0 in range(0, num_tiles, tb):
        t1 = min(num_tiles, t0 + tb)
        n = t1 - t0
        px, py = pixel_coords(torch.arange(t0, t1, device=dev), grid_x)
        st, cnt = starts[t0:t1], counts[t0:t1]
        fwd, dpk = packed[t0:t1], d_packed[t0:t1]
        n_contrib = fwd[:, C + 1]                                # [n,PIX]
        d_out = dpk[:, :C]                                       # [n,C,PIX]
        bg_term = fwd[:, C] * dpk[:, C]          # T_final * dL/dT_final
        # per-pixel total sum_j w_j g_j from the forward's own accumulation
        tot = torch.sum(fwd[:, :C] * d_out, dim=1)               # [n,PIX]
        Tc = torch.ones((n, TILE_PIX), dtype=torch.float32, device=dev)
        Pc = torch.zeros((n, TILE_PIX), dtype=torch.float32, device=dev)
        limit = min(int(n_contrib.max()), int(cnt.max()))
        for c0 in range(0, limit, CHUNK):
            pos = c0 + ks                                        # [K]
            rows, valid, idx = _instance_rows(table_p, gauss_id, st, cnt,
                                              pos, P)            # [n,K,R]
            dx, dy, power, raw = pair_terms(rows, px, py)
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            contrib = (valid[:, :, None] & (power <= 0.0)
                       & (alpha >= ALPHA_MIN)
                       & ((pos + 1)[None, :, None] <= n_contrib[:, None, :]))
            a = torch.where(contrib, alpha, 0.0)
            T_run = torch.cumprod(torch.cat([Tc[:, None, :], 1.0 - a], dim=1),
                                  dim=1)
            T_excl = T_run[:, :-1]
            Tc = T_run[:, -1]
            w = a * T_excl
            g = rows[:, :, ATTR_BASE, None] * d_out[:, None, 0]
            for c in range(1, C):
                g = g + rows[:, :, ATTR_BASE + c, None] * d_out[:, None, c]
            pref = Pc[:, None, :] + torch.cumsum(w * g, dim=1)
            Pc = pref[:, -1]
            suffix = tot[:, None, :] - pref
            # 1 - a >= 0.01 on a composited pair; elsewhere a = 0
            da = torch.where(
                contrib,
                T_excl * g - (suffix + bg_term[:, None, :]) / (1.0 - a), 0.0)
            # the 0.99 cap is a true min: no gradient through a capped alpha
            dpow = torch.where(contrib & (raw < ALPHA_MAX), raw * da, 0.0)
            dpx, dpy = dpow * dx, dpow * dy
            sx, sy = dpx.sum(-1), dpy.sum(-1)                    # [n,K]
            sxx, sxy, syy = ((dpx * dx).sum(-1), (dpx * dy).sum(-1),
                             (dpy * dy).sum(-1))
            s0 = dpow.sum(-1)
            A, B, Cc, op = (rows[:, :, j] for j in range(2, 6))
            live = op > 0.0
            cols = [-(A * sx + B * sy), -(Cc * sy + B * sx), -0.5 * sxx,
                    -sxy, -0.5 * syy,
                    torch.where(live, s0 / torch.where(live, op, 1.0), 0.0)]
            cols += [(w * d_out[:, None, c]).sum(-1) for c in range(Cg)]
            out[idx[valid]] = torch.stack(cols, dim=-1)[valid]
    return out


def composite_backward(table, gauss_id, starts, counts, grid_x: int,
                       packed, d_packed, Cg: int):
    """K2 wrapper: the per-instance gradient rows [I, 6+Cg] f32 (d mean2d,
    d conic, d opacity, d of the first ``Cg`` of the C features) from K1's
    inputs, its ``packed`` output [T, C+2, TILE_PIX] and the cotangent
    ``d_packed`` of the same shape (the n_contrib row's is ignored).  Every
    row is defined: zero for pad slots and for instances past their tile's
    last contributor.  A CPU tensor goes to ``composite_backward_plain``; a
    CUDA tensor launches ``csrc/composite_bwd.cu``."""
    dev = table.device
    req = _kernels.require
    _check_backward_inputs(table, gauss_id, starts, counts, grid_x, packed,
                           d_packed, Cg)
    num_tiles = starts.shape[0]
    P, R = table.shape
    C = R - ATTR_BASE
    if dev.type == "cpu":
        return composite_backward_plain(table, gauss_id, starts, counts,
                                        grid_x, packed, d_packed, Cg)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(TILE_PIX <= _MAX_THREADS and TILE_PIX % 32 == 0,
        f"TILE_X*TILE_Y={TILE_PIX} must be a multiple of 32 up to "
        f"{_MAX_THREADS}")
    lib = _kernels.lib()
    # the kernel writes the rows its walk reaches; the rest stay zero
    d_inst = torch.zeros((gauss_id.shape[0], ATTR_BASE + Cg),
                         dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gsplat_composite_backward(
            table.data_ptr(), P, C, Cg, gauss_id.data_ptr(),
            starts.data_ptr(), counts.data_ptr(), num_tiles, grid_x, TILE_X,
            TILE_Y, packed.data_ptr(), d_packed.data_ptr(),
            d_inst.data_ptr(), _kernels.stream_of(table))
    _kernels.check(err, "composite_backward")
    _kernels.launch_counts["composite_backward"] += 1
    return d_inst


class _Composite(torch.autograd.Function):
    """K1 forward; backward = K2, then the gather's adjoint (sort + K4)."""

    @staticmethod
    def forward(ctx, table, gauss_id, starts, counts, grid_x, Cg):
        packed = composite_forward(table, gauss_id, starts, counts, grid_x)
        ctx.save_for_backward(table, gauss_id, starts, counts, packed)
        ctx.grid_x, ctx.Cg = grid_x, Cg
        return packed

    @staticmethod
    def backward(ctx, d_packed):
        table, gauss_id, starts, counts, packed = ctx.saved_tensors
        P, R = table.shape
        d_inst = composite_backward(
            table, gauss_id, starts, counts, ctx.grid_x, packed,
            d_packed.to(torch.float32).contiguous(), ctx.Cg)
        d_table = segment_reduce.scatter_add_rows(d_inst, gauss_id, P)
        if d_table.shape[1] < R:     # the constant last feature: no gradient
            d_table = torch.cat(
                [d_table, d_table.new_zeros((P, R - d_table.shape[1]))], dim=1)
        return d_table, None, None, None, None, None


def unpack_tiles(packed, C: int, width: int, height: int):
    """[T, C+2, TILE_PIX] -> ([C, H, W] channels, [H, W] T_final); n_contrib
    (row C+1) stays tile-packed: only the backward kernel reads it."""
    grid_x = (width + TILE_X - 1) // TILE_X
    grid_y = (height + TILE_Y - 1) // TILE_Y
    full = packed[:, 0:C + 1].reshape(grid_y, grid_x, C + 1, TILE_Y, TILE_X)
    full = full.permute(2, 0, 3, 1, 4).reshape(
        C + 1, grid_y * TILE_Y, grid_x * TILE_X)[:, :height, :width]
    return full[:C], full[C]


def composite_cuda(means2d, conic, opacity, feats, bins: BinningOut,
                   width: int, height: int, const_last_feat: bool = False):
    """Tiled compositor: returns (img [C,H,W] pre-background, T_final [H,W],
    overflow []), differentiable in means2d, conic, opacity and feats.
    ``const_last_feat``: the caller marks feats' last column as a constant
    (the weight/ones channel); its gradient is never computed or reduced."""
    grid_x = (width + TILE_X - 1) // TILE_X
    C = feats.shape[1]
    table = torch.cat([means2d, conic, opacity[:, None], feats],
                      dim=1).to(torch.float32).contiguous()
    starts, counts = tile_ranges(bins)
    packed = _Composite.apply(table, bins.gauss_id.contiguous(), starts,
                              counts, grid_x, C - 1 if const_last_feat else C)
    img, T_final = unpack_tiles(packed, C, width, height)
    return img, T_final, bins.overflow
