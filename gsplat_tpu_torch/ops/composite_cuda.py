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

Both kernels have the compile-time forms of the Pallas kernels (``Form``):
``mxu_power`` takes the power as per-instance coefficients in tile-relative
coordinates times the pixel basis (1, x, y, x^2, y^2, xy), with a power
cut of 1e-4 (composite_pallas.py:130-151, :172); ``feat_packed``
(``feat_precision="bf16"``) reads the features as RNE bf16 pairs, two per
f32 word of a [P, 6 + ceil(Cg/2)] table, makes the constant ones channel in
the kernel, and K2 writes its feature-gradient rows as bf16 pairs again
(composite_pallas.py:191-223, :718-741).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gsplat_tpu_torch import _kernels, tracing
from gsplat_tpu_torch.ops import segment_reduce
from gsplat_tpu_torch.ops.binning import BinningOut
from gsplat_tpu_torch.ops.composite_ref import ALPHA_MAX, ALPHA_MIN, T_EPS
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

TILE_PIX = TILE_X * TILE_Y
ATTR_BASE = 6      # table columns: mean x, mean y, conic a, b, c, opacity
CHUNK = 128        # instances per step of the plain version
LOG2E = 1.4426950408889634
QUAD_POWER_CUT = 1e-4   # composite_pallas.py:172, the mxu_power form's cut
_KERNEL_BATCH = 128                 # kFwdBatch in composite_fwd.cuh
_MAX_THREADS = 1024                 # pixels a tile may have (kMaxThreads)
_SMEM_LIMIT = 232448                # bytes of shared memory a CTA can use
# K1's and K2's warp map (composite_common.cuh): a thread owns PIX_PER_THREAD
# consecutive pixels of a row, a warp a WARP_BLOCK block of them where the
# tile divides into such blocks, else 128 pixels in row-major order.  A CTA
# of K1 runs FWD_CTA_WARPS warps of a tile (composite_fwd.cuh::fwd_split).
PIX_PER_THREAD = 4
WARP_BLOCK = (16, 8)
FWD_CTA_WARPS = 4


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


class Form(NamedTuple):
    """A compile-time form of K1 and K2: the Pallas kernels' static
    ``mxu_power`` and ``fp`` (composite_pallas.py:247, :356)."""
    mxu_power: bool = False     # the power from tile-relative coefficients
    feat_packed: bool = False   # the features as bf16 pairs in the table
    with_ones: bool = False     # packed only: a last channel of ones

    @property
    def name(self) -> str:
        """The launch counters' suffix: "", "_quad", "_packed" or
        "_packed_quad"."""
        return ("_packed" if self.feat_packed else "") + (
            "_quad" if self.mxu_power else "")

    @property
    def bits(self) -> int:
        """The form as the C entries take it: 1 quad, 2 packed."""
        return int(self.mxu_power) | 2 * int(self.feat_packed)


F32 = Form()


def tile_basis(tiles, grid_x: int):
    """Tile origins ox, oy [n, 1] and the tile-local pixel basis qx, qy
    [1, TILE_PIX], float32."""
    lane = torch.arange(TILE_PIX, device=tiles.device)
    ox = ((tiles % grid_x) * TILE_X).to(torch.float32)[:, None]
    oy = ((tiles // grid_x) * TILE_Y).to(torch.float32)[:, None]
    qx = (lane % TILE_X).to(torch.float32)[None]
    qy = (lane // TILE_X).to(torch.float32)[None]
    return ox, oy, qx, qy


def pixel_warps(tile_x: int = TILE_X, tile_y: int = TILE_Y):
    """[tile_x * tile_y] int64: the warp of K1's and K2's walk that owns
    each tile pixel (row-major pixel index)."""
    pix = torch.arange(tile_x * tile_y)
    bx, by = WARP_BLOCK
    if tile_x % bx == 0 and tile_y % by == 0:
        return (pix // tile_x // by) * (tile_x // bx) + pix % tile_x // bx
    return pix // (32 * PIX_PER_THREAD)


def forward_ctas(tile_x: int = TILE_X, tile_y: int = TILE_Y):
    """[tile_x * tile_y] int64: the CTA of K1's tile split whose warps own
    each tile pixel (0 .. fwd_split - 1)."""
    return pixel_warps(tile_x, tile_y) // FWD_CTA_WARPS


def warp_boxes(tile_x: int = TILE_X, tile_y: int = TILE_Y):
    """[(x0, x1, y0, y1)] per warp: the tile-local box of its pixels, as
    ``warps_that_may_composite`` bounds it."""
    npix = tile_x * tile_y
    bx, by = WARP_BLOCK
    per = 32 * PIX_PER_THREAD
    boxes = []
    for w in range((npix + per - 1) // per):
        if tile_x % bx == 0 and tile_y % by == 0:
            x0, y0 = w % (tile_x // bx) * bx, w // (tile_x // bx) * by
            boxes.append((x0, x0 + bx - 1, y0, y0 + by - 1))
        else:
            p0, p1 = w * per, min(w * per + per, npix) - 1
            y0, y1 = p0 // tile_x, p1 // tile_x
            boxes.append((p0 - y0 * tile_x if y0 == y1 else 0,
                          p1 - y1 * tile_x if y0 == y1 else tile_x - 1,
                          y0, y1))
    return boxes


def _quad_min_box(a, b, c, xl, xh, yl, yh):
    """The least of a x^2 + 2 b x y + c y^2 over the box, elementwise, in
    the kernel's operation order (composite_common.cuh::quad_min_box)."""
    inside = (xl <= 0) & (xh >= 0) & (yl <= 0) & (yh >= 0)
    m = torch.full_like(a, float("inf"))
    for y, x2 in ((yl, xl), (yh, xh)):
        x = torch.fmin(torch.fmax(-b * y / a, xl), xh)
        m = torch.fmin(m, a * x * x + 2.0 * b * x * y + c * y * y)
        y2 = torch.fmin(torch.fmax(-b * x2 / c, yl), yh)
        m = torch.fmin(m, a * x2 * x2 + 2.0 * b * x2 * y2 + c * y2 * y2)
    return torch.where(inside, torch.zeros_like(m), m)


def warps_that_may_composite_plain(rows, ox, oy, real=None,
                                   tile_x: int = TILE_X,
                                   tile_y: int = TILE_Y):
    """Plain version of K1's and K2's per-warp cull
    (``csrc/composite_common.cuh::warps_that_may_composite``): int64 masks
    [n, K], bit w set where warp w's pixels may composite the instance of
    geometry ``rows`` [n, K, >=6] (mean, conic, opacity) in the tile at
    ``ox``, ``oy`` [n, 1].  A warp is left out only where the least
    quadratic form over its box keeps the power under the alpha >= 1/255
    threshold -ln(255 op) by the kernel's margin, 0.05 plus 1e-5 of the
    terms' magnitude.  A conic that is not positive definite or values that
    are not finite keep every bit; an opacity <= 0, and an instance whose
    ``real`` [n, K] is False (the pad sentinel), keep none."""
    mx, my, a, b, c, op = (rows[..., j] for j in range(6))
    boxes = warp_boxes(tile_x, tile_y)
    full = (1 << len(boxes)) - 1
    ok = ((a > 0) & (c > 0) & (a * c - b * b > 0) & torch.isfinite(mx)
          & torch.isfinite(my) & torch.isfinite(a) & torch.isfinite(b)
          & torch.isfinite(c))
    xr, yr = mx - ox, my - oy
    span = xr.abs() + yr.abs() + 2.0 * (tile_x + tile_y)
    limit = 2.0 * (torch.log(255.0 * op) + 0.05
                   + 1e-5 * (a + b.abs() + c) * span * span)
    may = torch.zeros(mx.shape, dtype=torch.int64, device=rows.device)
    for w, (x0, x1, y0, y1) in enumerate(boxes):
        q = _quad_min_box(a, b, c, xr - x1, xr - x0, yr - y1, yr - y0)
        may |= (~(q > limit)).long() << w
    may = torch.where(op > 0, may, torch.where(op <= 0, 0, full))
    may = torch.where(ok, may, full)
    return may if real is None else torch.where(real, may, 0)


def quad_power_coefficients(rows, ox, oy):
    """[n, K, 6] per-instance coefficients of the power in tile-relative
    coordinates (composite_pallas.py:131-140) from rows [n, K, 6+C] and the
    tile origins [n, 1]."""
    xr = rows[:, :, 0] - ox
    yr = rows[:, :, 1] - oy
    A, B, Cc = rows[:, :, 2], rows[:, :, 3], rows[:, :, 4]
    return torch.stack([
        -0.5 * (A * xr * xr + Cc * yr * yr) - B * xr * yr,
        A * xr + B * yr, Cc * yr + B * xr, -0.5 * A, -0.5 * Cc, -B], dim=-1)


def quad_power(coef, qx, qy):
    """power [n, K, TILE_PIX] = coef . (1, qx, qy, qx^2, qy^2, qx qy),
    summed left to right as K1 and K2 sum it."""
    c = [coef[:, :, j, None] for j in range(6)]
    return (c[0] + c[1] * qx + c[2] * qy + c[3] * (qx * qx)
            + c[4] * (qy * qy) + c[5] * (qx * qy))


def pair_terms(rows, px, py, quad=None):
    """``(dx, dy, power, raw)`` [n, K, TILE_PIX] of K instance rows
    [n, K, 6+C] at the pixel centres ``px``, ``py`` [n, TILE_PIX], one
    rounding per operation; ``raw`` is opacity * G before the 0.99 cap.
    ``quad`` = ``tile_basis``' (ox, oy, qx, qy) takes the power in the
    mxu_power form."""
    def col(j):
        return rows[:, :, j, None]                               # [n,K,1]

    dx = col(0) - px[:, None, :]                                 # [n,K,PIX]
    dy = col(1) - py[:, None, :]
    if quad is None:
        power = (-0.5 * (col(2) * dx * dx + col(4) * dy * dy)
                 - col(3) * dx * dy)
    else:
        ox, oy, qx, qy = quad
        power = quad_power(quad_power_coefficients(rows, ox, oy), qx, qy)
    return dx, dy, power, col(5) * torch.exp2(power * LOG2E)


def logical_table(table, form: Form = F32, Cg: Optional[int] = None):
    """The [P, 6+C] f32 rows K1 and K2 stage: ``table`` itself, or a packed
    table [P, 6 + ceil(Cg/2)] with its Cg features unpacked and the ones
    channel appended when ``form.with_ones`` (what the kernels make of
    each staged row)."""
    if not form.feat_packed:
        return table
    parts = [table[:, :ATTR_BASE],
             segment_reduce.unpack_bf16_pairs(table[:, ATTR_BASE:], Cg)]
    if form.with_ones:
        parts.append(table.new_ones((table.shape[0], 1)))
    return torch.cat(parts, dim=1)


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


def composite_forward_plain(table, gauss_id, starts, counts, grid_x: int,
                            form: Form = F32, Cg: Optional[int] = None):
    """Plain PyTorch version of K1: the same recurrence, vectorized over a
    batch of tiles and a CHUNK of instances at a time (the chunk-level
    recurrence of composite_tiled.compute_tile_weights, carried across
    chunks, with no per-tile instance cap).  Returns the packed
    [T, C+2, TILE_PIX] output.  It rounds the transmittance like the kernel;
    only the channel sums are taken in another order.  ``form`` and ``Cg``
    as ``composite_forward`` takes them."""
    dev = table.device
    table = logical_table(table, form, Cg)
    P, R = table.shape
    C = R - ATTR_BASE
    cut = QUAD_POWER_CUT if form.mxu_power else 0.0
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
        tiles = torch.arange(t0, t1, device=dev)
        px, py = pixel_coords(tiles, grid_x)
        quad = tile_basis(tiles, grid_x) if form.mxu_power else None
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
            _, _, power, raw = pair_terms(rows, px, py, quad)
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            mask = (valid[:, :, None] & (power <= cut) & (alpha >= ALPHA_MIN)
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


def _channels(table, form: Form, Cg: Optional[int]) -> int:
    """The C channels K1 composites from ``table`` in ``form``: the table's
    own [P, 6+C] columns, or, packed, the Cg features of a
    [P, 6 + ceil(Cg/2)] table and the ones channel made in the kernel."""
    req = _kernels.require
    width = table.shape[1] - ATTR_BASE
    if not form.feat_packed:
        req(not form.with_ones, "with_ones is a form of the packed table")
        return width
    req(Cg is not None and Cg >= 1,
        f"the packed form needs Cg >= 1 stored features, got {Cg}")
    req(width == (Cg + 1) // 2,
        f"a packed table of Cg={Cg} features is [P, {ATTR_BASE + (Cg + 1) // 2}]"
        f", got {tuple(table.shape)}")
    return Cg + int(form.with_ones)


def _check_backward_inputs(table, gauss_id, starts, counts, grid_x: int,
                           packed, d_packed, Cg: int, form: Form = F32):
    """What K2 takes beyond K1's inputs: ``Cg`` and the two packed arrays.
    Returns the C channels."""
    req = _kernels.require
    _check_tile_inputs(table, gauss_id, starts, counts, grid_x)
    num_tiles = starts.shape[0]
    C = _channels(table, form, Cg)
    req(0 <= Cg <= C, f"Cg={Cg} outside [0, C={C}]")
    for name, t in (("packed", packed), ("d_packed", d_packed)):
        req(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
        req(t.shape == (num_tiles, C + 2, TILE_PIX),
            f"{name} must be [{num_tiles}, {C + 2}, {TILE_PIX}], got "
            f"{tuple(t.shape)}")
        req(t.is_contiguous(), f"{name} must be contiguous")
        req(t.device == table.device,
            f"{name} is on {t.device}, expected {table.device}")
    return C


def composite_forward(table, gauss_id, starts, counts, grid_x: int,
                      form: Form = F32, Cg: Optional[int] = None):
    """K1 wrapper: packed [T, C+2, TILE_PIX] f32 (C composited channels,
    T_final, n_contrib) for the per-gaussian attribute ``table`` [P, 6+C]
    (mean2d, conic, opacity, features) and the sorted ``gauss_id`` [I] with
    per-tile ``starts``/``counts`` [T] (already clamped into [0, I)).
    ``form.feat_packed``: the table is [P, 6 + ceil(Cg/2)] with the Cg
    features as bf16 pairs, and C = Cg + ``form.with_ones``.
    A CPU tensor goes to ``composite_forward_plain``; a CUDA tensor
    launches ``csrc/composite_fwd.cu`` (the f32 form) or
    ``csrc/composite_fwd_forms.cu``, each form counted apart."""
    dev = table.device
    req = _kernels.require
    _check_tile_inputs(table, gauss_id, starts, counts, grid_x)
    C = _channels(table, form, Cg)
    num_tiles = starts.shape[0]
    if dev.type == "cpu":
        return composite_forward_plain(table, gauss_id, starts, counts, grid_x,
                                       form, Cg)
    req(dev.type == "cuda", f"unsupported device {dev}")
    P = table.shape[0]
    req(TILE_PIX <= _MAX_THREADS,
        f"tiles of {TILE_X}x{TILE_Y}: K1 takes at most {_MAX_THREADS} pixels")
    # a batch's rows, cull masks and (mxu_power) six coefficients per
    # instance
    req(_KERNEL_BATCH * (ATTR_BASE + C + 1 + 6 * form.mxu_power) * 4
        <= _SMEM_LIMIT,
        f"C={C} channels exceed the kernel's shared-memory batch")
    out = torch.empty((num_tiles, C + 2, TILE_PIX), dtype=torch.float32,
                      device=dev)
    lib = _kernels.lib()
    tail = (gauss_id.data_ptr(), starts.data_ptr(), counts.data_ptr(),
            num_tiles, grid_x, TILE_X, TILE_Y, out.data_ptr(),
            _kernels.stream_of(table))
    with torch.cuda.device(dev):
        if form == F32:
            err = lib.gsplat_composite_forward(table.data_ptr(), P, C, *tail)
        else:
            err = lib.gsplat_composite_forward_form(
                form.bits, table.data_ptr(), P, C,
                Cg if form.feat_packed else C, *tail)
    name = "composite_forward" + form.name
    _kernels.check(err, name)
    _kernels.launch_counts[name] += 1
    return out


def composite_backward_plain(table, gauss_id, starts, counts, grid_x: int,
                             packed, d_packed, Cg: int, form: Form = F32):
    """Plain PyTorch version of K2: the same forward walk as
    ``composite_forward_plain`` (tile batches, CHUNK instances at a time,
    transmittance and the prefix of w*g carried across chunks), gated by
    K1's ``n_contrib``.  Returns the per-instance gradient rows
    [I, 6+Cg]: d mean2d, d conic, d opacity, d of the first Cg features;
    rows of slots no tile owns, and of instances past a tile's last
    contributor, are zero.  In the packed form the Cg feature columns are
    RNE bf16 pairs, [I, 6 + ceil(Cg/2)], as K2 writes them."""
    dev = table.device
    table = logical_table(table, form, Cg)
    P, R = table.shape
    C = R - ATTR_BASE
    cut = QUAD_POWER_CUT if form.mxu_power else 0.0
    I = gauss_id.shape[0]
    num_tiles = starts.shape[0]
    table_p = torch.cat([table, table.new_zeros((1, R))])    # sentinel row P
    out = torch.zeros((I, ATTR_BASE + Cg), dtype=torch.float32, device=dev)
    tb = max(1, (1 << 25) // (CHUNK * TILE_PIX))
    ks = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    for t0 in range(0, num_tiles, tb):
        t1 = min(num_tiles, t0 + tb)
        n = t1 - t0
        tiles = torch.arange(t0, t1, device=dev)
        px, py = pixel_coords(tiles, grid_x)
        quad = tile_basis(tiles, grid_x) if form.mxu_power else None
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
            dx, dy, power, raw = pair_terms(rows, px, py, quad)
            alpha = torch.clamp(raw, max=ALPHA_MAX)
            contrib = (valid[:, :, None] & (power <= cut)
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
    if form.feat_packed:
        out = torch.cat([out[:, :ATTR_BASE], segment_reduce.pack_bf16_pairs(
            out[:, ATTR_BASE:])], dim=1)
    return out


def composite_backward(table, gauss_id, starts, counts, grid_x: int,
                       packed, d_packed, Cg: int, form: Form = F32):
    """K2 wrapper: the per-instance gradient rows [I, 6+Cg] f32 (d mean2d,
    d conic, d opacity, d of the first ``Cg`` of the C features) from K1's
    inputs, its ``packed`` output [T, C+2, TILE_PIX] and the cotangent
    ``d_packed`` of the same shape (the n_contrib row's is ignored).  Every
    row is defined: zero for pad slots and for instances past their tile's
    last contributor.  In the packed form (``composite_forward``'s) Cg is
    the number of stored features and the rows are [I, 6 + ceil(Cg/2)],
    the feature gradients as RNE bf16 pairs.  A CPU tensor goes to
    ``composite_backward_plain``; a CUDA tensor launches
    ``csrc/composite_bwd.cu`` (the f32 form) or
    ``csrc/composite_bwd_forms.cu``, each form counted apart."""
    dev = table.device
    req = _kernels.require
    C = _check_backward_inputs(table, gauss_id, starts, counts, grid_x,
                               packed, d_packed, Cg, form)
    num_tiles = starts.shape[0]
    P = table.shape[0]
    if dev.type == "cpu":
        return composite_backward_plain(table, gauss_id, starts, counts,
                                        grid_x, packed, d_packed, Cg, form)
    req(dev.type == "cuda", f"unsupported device {dev}")
    req(TILE_PIX <= _MAX_THREADS and TILE_PIX % 32 == 0,
        f"TILE_X*TILE_Y={TILE_PIX} must be a multiple of 32 up to "
        f"{_MAX_THREADS}")
    lib = _kernels.lib()
    width = ATTR_BASE + ((Cg + 1) // 2 if form.feat_packed else Cg)
    # the kernel writes the rows its walk reaches; the rest stay zero
    d_inst = torch.zeros((gauss_id.shape[0], width), dtype=torch.float32,
                         device=dev)
    args = (table.data_ptr(), P, C, Cg, gauss_id.data_ptr(),
            starts.data_ptr(), counts.data_ptr(), num_tiles, grid_x, TILE_X,
            TILE_Y, packed.data_ptr(), d_packed.data_ptr(),
            d_inst.data_ptr(), _kernels.stream_of(table))
    with torch.cuda.device(dev):
        if form == F32:
            err = lib.gsplat_composite_backward(*args)
        else:
            err = lib.gsplat_composite_backward_form(form.bits, *args)
    name = "composite_backward" + form.name
    _kernels.check(err, name)
    _kernels.launch_counts[name] += 1
    return d_inst


def backward_occupancy(C: int, Cg: int, form: Form = F32) -> int:
    """CTAs of K2's kernel in ``form`` that one SM of the current card holds
    at once at this tile shape, C and Cg (``chip_smoke.py`` prints them
    beside ptxas's registers); needs a card."""
    lib = _kernels.lib()
    if form == F32:
        n = lib.gsplat_composite_backward_occupancy(C, Cg, TILE_X, TILE_Y)
    else:
        n = lib.gsplat_composite_backward_form_occupancy(form.bits, C, Cg,
                                                         TILE_X, TILE_Y)
    _kernels.require(n > 0, f"K2{form.name}: no occupancy at C={C}, Cg={Cg}")
    return n


def forward_occupancy(C: int, Cg: int, form: Form = F32) -> int:
    """CTAs of K1's kernel in ``form`` that one SM of the current card holds
    at once at this tile shape, C and Cg (``composite_forward``'s: the
    stored features, C unless packed); needs a card."""
    lib = _kernels.lib()
    if form == F32:
        n = lib.gsplat_composite_forward_occupancy(C, TILE_X, TILE_Y)
    else:
        n = lib.gsplat_composite_forward_form_occupancy(form.bits, C, Cg,
                                                        TILE_X, TILE_Y)
    _kernels.require(n > 0, f"K1{form.name}: no occupancy at C={C}, Cg={Cg}")
    return n


def warp_map_errors(tile_x: int = TILE_X, tile_y: int = TILE_Y) -> dict:
    """The check of the warp map K1 and K2 share against the boxes their
    cull bounds (``csrc/composite_fwd.cu::gsplat_warp_map_check``) at a
    tile shape, on the card: dict(outside: pixels a thread owns outside its
    warp's box, misowned: pixels not owned by exactly one thread), both 0
    where the cull is sound; needs a card."""
    npix = tile_x * tile_y
    out = torch.zeros(npix + 1, dtype=torch.int32, device="cuda")
    _kernels.check(_kernels.lib().gsplat_warp_map_check(
        tile_x, tile_y, out.data_ptr(), _kernels.stream_of(out)),
        "warp_map_check")
    out = out.cpu()
    return dict(outside=int(out[0]), misowned=int((out[1:] != 1).sum()))


def scrub_nonfinite(d_inst, form: Form = F32):
    """Zeroes, in place, the non-finite values of K2's rows before they are
    reduced (the finite half of composite_pallas.py:666-677's scrub; the
    written half is K2's own zero fill).  The packed feature words are left
    as they are: a bf16 pair can alias an f32 inf or NaN (:670-676)."""
    cols = d_inst[:, :ATTR_BASE] if form.feat_packed else d_inst
    torch.nan_to_num_(cols, nan=0.0, posinf=0.0, neginf=0.0)
    return d_inst


class _Composite(torch.autograd.Function):
    """K1 forward; backward = K2, the finite scrub, then the gather's
    adjoint (``segment_reduce.reduce_rows``: the bf16 rounding and the
    packed tail, the sort and K4)."""

    @staticmethod
    def forward(ctx, table, gauss_id, starts, counts, grid_x, Cg, form=F32,
                grad_precision="f32"):
        packed = composite_forward(table, gauss_id, starts, counts, grid_x,
                                   form, Cg)
        ctx.save_for_backward(table, gauss_id, starts, counts, packed)
        ctx.grid_x, ctx.Cg, ctx.form = grid_x, Cg, form
        ctx.grad_precision = grad_precision
        return packed

    @staticmethod
    def backward(ctx, d_packed):
        table, gauss_id, starts, counts, packed = ctx.saved_tensors
        P, R = table.shape
        form = ctx.form
        with tracing.span("composite.backward"):
            d_inst = scrub_nonfinite(composite_backward(
                table, gauss_id, starts, counts, ctx.grid_x, packed,
                d_packed.to(torch.float32).contiguous(), ctx.Cg, form), form)
            d_table = segment_reduce.reduce_rows(
                d_inst, gauss_id, P, ctx.grad_precision,
                R - ATTR_BASE if form.feat_packed else 0)
            if d_table.shape[1] < R:  # the constant last feature: no gradient
                d_table = torch.cat(
                    [d_table, d_table.new_zeros((P, R - d_table.shape[1]))],
                    dim=1)
        return d_table, None, None, None, None, None, None, None


class _PackFeats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats):
        ctx.Cg = feats.shape[1]
        return segment_reduce.pack_bf16_pairs(feats)

    @staticmethod
    def backward(ctx, d_packed):
        return segment_reduce.unpack_bf16_pairs(d_packed, ctx.Cg)


def pack_feats(feats, Cg: int):
    """[P, Cg] f32 -> [P, ceil(Cg/2)] RNE bf16 pairs, whose adjoint takes
    packed per-gaussian gradient pairs (``reduce_rows``' packed tail) and
    unpacks them (composite_pallas.py::pack_feats :226-244)."""
    _kernels.require(feats.shape[1] == Cg,
                     f"feats has {feats.shape[1]} columns, Cg={Cg}")
    return _PackFeats.apply(feats)


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
                   width: int, height: int, const_last_feat: bool = False,
                   grad_precision: str = "f32", mxu_power: bool = False,
                   feat_precision: str = "f32"):
    """Tiled compositor: returns (img [C,H,W] pre-background, T_final [H,W],
    overflow []), differentiable in means2d, conic, opacity and feats.
    ``const_last_feat``: the caller marks feats' last column as a constant
    (the weight/ones channel); its gradient is never computed or reduced.
    ``grad_precision``, ``mxu_power`` and ``feat_precision`` as the JAX
    package's ``composite_pallas`` takes them: bf16 per-instance gradient
    rows, the tile-relative quadratic power, and the features packed as
    bf16 pairs with the ones channel made in the kernels."""
    grid_x = (width + TILE_X - 1) // TILE_X
    C = feats.shape[1]
    Cg = C - 1 if const_last_feat else C
    feat_packed = feat_precision == "bf16"
    form = Form(bool(mxu_power), feat_packed,
                feat_packed and bool(const_last_feat))
    cols = (pack_feats(feats[:, :Cg].to(torch.float32), Cg) if feat_packed
            else feats)
    table = torch.cat([means2d, conic, opacity[:, None], cols],
                      dim=1).to(torch.float32).contiguous()
    starts, counts = tile_ranges(bins)
    packed = _Composite.apply(table, bins.gauss_id.contiguous(), starts,
                              counts, grid_x, Cg, form, grad_precision)
    img, T_final = unpack_tiles(packed, C, width, height)
    return img, T_final, bins.overflow
