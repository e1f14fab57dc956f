"""Tile binning: duplicate gaussians per touched tile, sort by (tile, depth),
find per-tile ranges with ALIGN-aligned per-tile segments.

PyTorch port of ``gsplat_tpu/ops/binning.py`` (see that module for the
design).  On the ``cull="none"`` path, in order:

- the per-tile instance histogram from a 2D difference array of the tile
  rects (``_tile_histogram``);
- per-tile alignment pads and ``tile_start`` from the padded prefix sum;
- the depth-major gaussian order: a stable argsort of the int32 bits of the
  view depths (positive floats sort like their bits), invisible gaussians
  last;
- the packed sources (gaussians, per-tile pads, tail sentinel) and their
  expansion into per-instance (tile, gaussian id) pairs by kernel K3
  (``expand``; ``csrc/expand.cu``);
- one stable sort on the tile id, which keeps the depth order within tiles.

``cull="exact"`` (``_bin_gaussians_culled``) drops every (gaussian, tile)
instance whose ellipse provably misses the tile, in two expansions: stage A
spreads each gaussian over its tile rows with the extras form of K3
(``expand(..., extras=...)``, which also forwards 8 f32 attributes per
row), the exact per-row tile range is plain torch, and stage B is the
no-extras expansion over the clipped rows.

Everything has a fixed capacity ``max_instances`` (and, under exact cull, a
row capacity ``max_rows``); overflow is reported, never an out-of-bounds
write.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch import _kernels, tracing
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y, PreprocessOut

EXPAND_CHUNK = 1024   # the JAX kernel's slots per program (_EXP_CH): the
                      # exact-cull capacities are multiples of it
MAX_EXTRA = 13        # extras rows K3 forwards (3 + n_extra <= 16 there)


class BinningOut(NamedTuple):
    gauss_id: torch.Tensor      # [I] int32 sorted gaussian index (P = pad/sentinel)
    tile_id: torch.Tensor       # [I] int32 sorted tile index (num_tiles = pad)
    tile_start: torch.Tensor    # [T] int32 ALIGN-aligned start offset per tile
    tile_count: torch.Tensor    # [T] int32 REAL instances per tile (pads excluded)
    num_rendered: torch.Tensor  # [] int32 true instance count (may exceed capacity)
    num_padded: torch.Tensor    # [] int32 true PADDED demand (instances + pads)
    overflow: torch.Tensor      # [] bool capacity exceeded


class ExpansionSources(NamedTuple):
    """What K3 expands: S = P + T + 1 sources laid end to end."""
    offsets: torch.Tensor       # [S] int32 first instance of each source
    meta: torch.Tensor          # [S] int32 packed (base, rw, colstep)
    gid: torch.Tensor           # [S] int32 gaussian id (P for pads and tail)
    rw_bits: int
    counts: torch.Tensor        # [T] int32 real instances per tile
    tile_start: torch.Tensor    # [T] int32
    num_rendered: torch.Tensor  # [] int32
    num_padded: torch.Tensor    # [] int32


def _tile_histogram(pre: PreprocessOut, grid_x: int, grid_y: int):
    """Per-tile real instance counts from a 2D difference array: +1 at the
    rect's (x0,y0) and (x1,y1) corners, -1 at (x1,y0) and (x0,y1), then a
    2D prefix sum.  Culled gaussians deposit into a dump cell.  Integer
    scatter-adds are exact, so this equals the JAX sort+searchsorted
    histogram bit for bit."""
    W, H = grid_x + 1, grid_y + 1
    dump = H * W
    v = pre.visible
    x0, y0 = pre.rect_min[:, 0], pre.rect_min[:, 1]
    x1, y1 = pre.rect_max[:, 0], pre.rect_max[:, 1]
    pos = torch.cat([torch.where(v, y0 * W + x0, dump),
                     torch.where(v, y1 * W + x1, dump)])
    neg = torch.cat([torch.where(v, y0 * W + x1, dump),
                     torch.where(v, y1 * W + x0, dump)])
    h2 = torch.zeros(H * W + 1, dtype=torch.int32, device=v.device)
    h2.scatter_add_(0, pos.long(), torch.ones_like(pos))
    h2.scatter_add_(0, neg.long(), torch.full_like(neg, -1))
    counts = torch.cumsum(torch.cumsum(h2[:H * W].view(H, W), dim=0), dim=1)
    return counts[:grid_y, :grid_x].reshape(-1).to(torch.int32)     # [T]


def _exclusive_cumsum(x):
    return (torch.cumsum(x, dim=0) - x).to(torch.int32)


def depth_order(pre: PreprocessOut):
    """The depth-major gaussian order: a stable argsort of the int32 bits of
    the view depths (positive floats sort like their bits), invisible
    gaussians last."""
    depth_bits_g = pre.depths.to(torch.float32).view(torch.int32)
    dkey = torch.where(pre.visible, depth_bits_g, 0x7FFFFFFF)
    return torch.argsort(dkey, stable=True).to(torch.int32)        # [P]


def meta_layout(grid_x: int, num_tiles: int, align: int):
    """(rw_cap, rw_bits, pack_meta) of the packed (base | rw | colstep)
    meta word."""
    rw_cap = max(grid_x, align, 2)
    rw_bits = int(rw_cap).bit_length()
    base_bits = int(num_tiles).bit_length()
    if 1 + rw_bits + base_bits > 31:
        raise ValueError("tile grid too large for the packed meta word")

    def pack_meta(base, rw, colstep):
        return ((base << (rw_bits + 1)) | (rw << 1) | colstep).to(torch.int32)

    return rw_cap, rw_bits, pack_meta


def _pad_and_tail_meta(num_tiles: int, align: int, rw_cap: int, pack_meta,
                       dev):
    """Meta words of the per-tile pad sources and the tail sentinel."""
    tids = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    meta_pad = pack_meta(tids, torch.full_like(tids, align if align > 1 else 1),
                         torch.zeros_like(tids))
    # on a card the copy from the host waits for the queue
    with tracing.span("sync"):
        tail = torch.tensor([num_tiles], dtype=torch.int32, device=dev)
    meta_tail = pack_meta(tail, rw_cap, 0)
    return torch.cat([meta_pad, meta_tail])


def expansion_sources(pre: PreprocessOut, grid_x: int, grid_y: int,
                      align: int) -> ExpansionSources:
    """Everything of ``bin_gaussians`` before the expansion: histogram,
    pads, tile starts, the depth order and the packed sources."""
    P = pre.depths.shape[0]
    num_tiles = grid_x * grid_y
    dev = pre.depths.device
    i32 = dict(dtype=torch.int32, device=dev)

    tiles_touched = pre.tiles_touched
    num_rendered = torch.sum(tiles_touched, dtype=torch.int32)
    order = depth_order(pre)                                       # [P]

    counts = _tile_histogram(pre, grid_x, grid_y)                  # [T]
    pads = torch.remainder(-counts, align)                         # 0 for empty
    padded = counts + pads
    tile_start = _exclusive_cumsum(padded)
    total_padded = num_rendered + torch.sum(pads, dtype=torch.int32)

    src_tbl = torch.stack(
        [tiles_touched, pre.rect_min[:, 0], pre.rect_min[:, 1],
         torch.clamp(pre.rect_max[:, 0] - pre.rect_min[:, 0], min=1)],
        dim=1).to(torch.int32)[order.long()]                       # [P,4]
    offsets_real = _exclusive_cumsum(src_tbl[:, 0])                # [P]
    offsets_pad = num_rendered + _exclusive_cumsum(pads)           # [T]

    # packed meta word: tile = base + (k // rw) * grid_x + (k % rw) * colstep
    # covers real sources (base = ty0*grid_x+tx0, rw = rect width,
    # colstep = 1), per-tile pads (base = tile, rw = align, colstep = 0) and
    # the tail sentinel (base = num_tiles)
    rw_cap, rw_bits, pack_meta = meta_layout(grid_x, num_tiles, align)
    base_real = src_tbl[:, 2] * grid_x + src_tbl[:, 1]
    meta_real = pack_meta(base_real, src_tbl[:, 3], torch.ones_like(base_real))
    return ExpansionSources(
        offsets=torch.cat([offsets_real, offsets_pad,
                           total_padded.reshape(1)]).contiguous(),
        meta=torch.cat([meta_real, _pad_and_tail_meta(
            num_tiles, align, rw_cap, pack_meta, dev)]).contiguous(),
        gid=torch.cat([order, torch.full((num_tiles + 1,), P, **i32)]
                      ).contiguous(),
        rw_bits=rw_bits,
        counts=counts,
        tile_start=tile_start,
        num_rendered=num_rendered,
        num_padded=total_padded,
    )


def expand_plain(offsets, meta, gid, I: int, rw_bits: int, grid_x: int,
                 num_tiles: int, extras=()):
    """Plain PyTorch version of K3: the owner of slot i is the last source
    with offset <= i (``searchsorted(..., right=True) - 1``), then the same
    decode as the kernel.  With ``extras`` ([n_extra, S] float32) it also
    returns each slot's owner's extras, [n_extra, I]."""
    pos = torch.arange(I, dtype=torch.int32, device=offsets.device)
    src = torch.clamp(
        torch.searchsorted(offsets, pos, right=True) - 1, min=0)
    k = pos - offsets[src]
    m = meta[src]
    colstep = m & 1
    rw = (m >> 1) & ((1 << rw_bits) - 1)
    base = m >> (rw_bits + 1)
    q = torch.div(k, rw, rounding_mode="floor")
    tile = base + q * grid_x + (k - q * rw) * colstep
    out = (torch.clamp(tile, max=num_tiles).to(torch.int32),
           gid[src].to(torch.int32))
    if len(extras) == 0:
        return out
    return out + (extras[:, src],)


SEARCH_LANES = 16     # lanes of K3's partition search per end of a CTA


class ExpandPartition(NamedTuple):
    """K3's partition of the merge of the sources and the slots, one row
    per CTA (``expand_partition_plain``)."""
    slot_start: torch.Tensor    # [n] int32 first slot of each CTA
    source_start: torch.Tensor  # [n] int32 first source each CTA consumes
    first_owner: torch.Tensor   # [n] int32 owner of the CTA's first slot
    probes: int                 # offsets the search loads, over all CTAs


def _merge_split(offsets, I: int, diag):
    """(a, loads) for each diagonal ``diag`` [n] of the merge: ``a`` the
    sources among its first ``diag`` items, found as K3's partition finds
    it (csrc/expand.cu ``merge_split``), and the offsets each search
    loads.  Source s comes before slot j when offsets[s] <= j, so its place
    in the merge is s + min(offsets[s], I): it lies before the diagonal iff
    that is < diag.  The search narrows [max(0, diag - I), min(diag, S)]
    by SEARCH_LANES probes at a time."""
    S = offsets.shape[0]
    d = diag.long()
    lo = torch.clamp(d - I, min=0)
    hi = torch.clamp(d, max=S)
    off = torch.clamp(offsets.long(), max=I)
    lanes = torch.arange(SEARCH_LANES, device=d.device)
    loads = torch.zeros_like(d)
    while True:
        active = hi > lo
        if not bool(active.any()):
            return lo, loads
        step = torch.where(active, (hi - lo + SEARCH_LANES - 1)
                           // SEARCH_LANES, 0)
        s = lo[:, None] + lanes[None, :] * step[:, None]
        valid = active[:, None] & (s < hi[:, None])
        loads += valid.sum(dim=1)
        before = valid & (s + off[s.clamp(max=S - 1)] < d[:, None])
        cnt = before.sum(dim=1)
        lo, hi = (torch.where(active & (cnt > 0), lo + (cnt - 1) * step + 1,
                              lo),
                  torch.where(active, torch.where(
                      cnt > 0, torch.minimum(hi, lo + cnt * step), lo), hi))


def expand_partition_plain(offsets, I: int, items: int) -> ExpandPartition:
    """Plain version of K3's partition: the merge of the S sources and the
    I slots (sources first on ties) cut into CTAs of ``items`` merged items
    each.  Per CTA: its first slot, its first source, and the owner of its
    first slot by the kernel's rule: the last source consumed before its
    diagonal (0 if there is none), unless the tie group at that slot runs
    on into the CTA, whose last source then owns it."""
    S = offsets.shape[0]
    dev = offsets.device
    n = (S + I + items - 1) // items
    diag = torch.clamp(torch.arange(n + 1, device=dev) * items, max=S + I)
    a, loads = _merge_split(offsets, I, diag)
    b = diag - a
    a0, a1, b0, b1 = a[:-1], a[1:], b[:-1], b[1:]
    first = torch.clamp(a0 - 1, min=0)
    # the scatter of the kernel's merge: the last source of each tie group
    # marks its offset; a CTA's first slot takes the mark of a source it
    # consumed itself
    src = torch.arange(S, device=dev)
    off = offsets.long()
    last = torch.ones(S, dtype=torch.bool, device=dev)
    last[:-1] = off[1:] != off[:-1]
    cta = torch.searchsorted(a1, src, right=True)   # the CTA consuming src
    hit = last & (off == b0[cta]) & (b0[cta] < b1[cta])
    first = first.scatter_reduce(0, cta[hit], src[hit], "amax")
    return ExpandPartition(slot_start=b0.to(torch.int32),
                           source_start=a0.to(torch.int32),
                           first_owner=first.to(torch.int32),
                           probes=int(loads[:-1].sum() + loads[1:].sum()))


def expand(offsets, meta, gid, I: int, rw_bits: int, grid_x: int,
           num_tiles: int, extras=()):
    """K3 wrapper: ``(tile [I], gid [I])`` int32 for the packed sources,
    plus ``extras_out [n_extra, I]`` float32 when ``extras`` ([n_extra, S]
    float32, contiguous, 1 <= n_extra <= 13) is given.  A CPU tensor goes
    to ``expand_plain``; a CUDA tensor launches ``csrc/expand.cu``
    (``gsplat_expand``, or ``gsplat_expand_extras`` with extras)."""
    dev = offsets.device
    S = offsets.shape[0]
    for name, t in (("offsets", offsets), ("meta", meta), ("gid", gid)):
        _kernels.check_int32_vector(name, t, dev, S)
    _kernels.require(I > 0, f"capacity I must be positive, got {I}")
    n_extra = len(extras)
    if n_extra:
        _kernels.require(isinstance(extras, torch.Tensor),
                         "extras must be one [n_extra, S] tensor")
        _kernels.require(extras.dtype == torch.float32,
                         f"extras must be float32, got {extras.dtype}")
        _kernels.require(extras.dim() == 2 and extras.shape[1] == S,
                         f"extras must be [n_extra, {S}], got "
                         f"{tuple(extras.shape)}")
        _kernels.require(1 <= n_extra <= MAX_EXTRA,
                         f"n_extra must be in [1, {MAX_EXTRA}], got {n_extra}")
        _kernels.require(extras.is_contiguous(), "extras must be contiguous")
        _kernels.require(extras.device == dev,
                         f"extras is on {extras.device}, expected {dev}")
    if dev.type == "cpu":
        return expand_plain(offsets, meta, gid, I, rw_bits, grid_x, num_tiles,
                            extras)
    _kernels.require(dev.type == "cuda", f"unsupported device {dev}")
    tile = torch.empty(I, dtype=torch.int32, device=dev)
    gid_out = torch.empty(I, dtype=torch.int32, device=dev)
    lib = _kernels.lib()
    if n_extra == 0:
        with torch.cuda.device(dev):
            err = lib.gsplat_expand(
                offsets.data_ptr(), meta.data_ptr(), gid.data_ptr(), S, I,
                rw_bits, grid_x, num_tiles, tile.data_ptr(),
                gid_out.data_ptr(), _kernels.stream_of(offsets))
        _kernels.check(err, "expand")
        _kernels.launch_counts["expand"] += 1
        return tile, gid_out
    extras_out = torch.empty((n_extra, I), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gsplat_expand_extras(
            offsets.data_ptr(), meta.data_ptr(), gid.data_ptr(),
            extras.data_ptr(), S, I, rw_bits, grid_x, num_tiles, n_extra,
            tile.data_ptr(), gid_out.data_ptr(), extras_out.data_ptr(),
            _kernels.stream_of(offsets))
    _kernels.check(err, "expand_extras")
    _kernels.launch_counts["expand_extras"] += 1
    return tile, gid_out, extras_out


def row_capacity(max_instances: int, max_rows: int = 0) -> int:
    """Stage A's row capacity: ``max_rows``, or half the instance capacity
    (at least one chunk), rounded up to a multiple of EXPAND_CHUNK."""
    IR = max_rows if max_rows > 0 else max(EXPAND_CHUNK, max_instances // 2)
    return (IR + EXPAND_CHUNK - 1) // EXPAND_CHUNK * EXPAND_CHUNK


class RowSources(NamedTuple):
    """What stage A of exact-cull binning expands with the extras form of
    K3: S_A = P + 1 sources (one per gaussian in depth order, one slot per
    tile row of its rect, then the tail sentinel)."""
    offsets: torch.Tensor       # [S_A] int32 first row of each source
    meta: torch.Tensor          # [S_A] int32 packed (base = rect y0, rw_cap, 1)
    gid: torch.Tensor           # [S_A] int32 gaussian id (P for the tail)
    extras: torch.Tensor        # [8, S_A] f32 mx, my, conic a/b/c, tau,
                                # rect x0, rect width (0 for the tail)
    rows_total: torch.Tensor    # [] int32 rows of all visible gaussians


def row_sources(pre: PreprocessOut, grid_x: int, grid_y: int,
                align: int) -> RowSources:
    """Stage A's sources (JAX ``binning.py:252-279``).  The row walk packs
    base = rect_min_y, rw = rw_cap (so k // rw == 0) and colstep 1, so the
    kernel's tile is the row index y0 + k, clamped to ``grid_y``."""
    P = pre.depths.shape[0]
    dev = pre.depths.device
    i32 = dict(dtype=torch.int32, device=dev)
    f32 = torch.float32
    rw_cap, _, pack_meta = meta_layout(grid_x, grid_x * grid_y, align)
    order = depth_order(pre).long()
    rect_w = torch.clamp(pre.rect_max[:, 0] - pre.rect_min[:, 0], min=1)
    rect_h = torch.clamp(pre.rect_max[:, 1] - pre.rect_min[:, 1], min=1)
    rh_s = torch.where(pre.visible, rect_h, 0).to(torch.int32)[order]
    tau = torch.log(torch.clamp(255.0 * pre.opacity, min=1e-6)) + 1e-3
    rows_total = torch.sum(rh_s, dtype=torch.int32)
    y0 = pre.rect_min[:, 1].to(torch.int32)[order]
    with tracing.span("sync"):
        tail = torch.tensor([grid_y], **i32)
    meta = torch.cat([
        pack_meta(y0, torch.full_like(y0, rw_cap), torch.ones_like(y0)),
        pack_meta(tail, rw_cap, 0)])
    extras = torch.cat([
        torch.stack([pre.means2d[:, 0], pre.means2d[:, 1], pre.conic[:, 0],
                     pre.conic[:, 1], pre.conic[:, 2], tau,
                     pre.rect_min[:, 0].to(f32), rect_w.to(f32)])[:, order],
        torch.zeros((8, 1), dtype=f32, device=dev)], dim=1)
    return RowSources(
        offsets=torch.cat([_exclusive_cumsum(rh_s),
                           rows_total.reshape(1)]).contiguous(),
        meta=meta.contiguous(),
        gid=torch.cat([order.to(torch.int32),
                       torch.full((1,), P, **i32)]).contiguous(),
        extras=extras.contiguous(),
        rows_total=rows_total,
    )


def _bin_gaussians_culled(pre: PreprocessOut, grid_x: int, grid_y: int,
                          I: int, align: int, max_rows: int) -> BinningOut:
    """Two-stage expansion with exact ellipse-vs-tile culling (JAX
    ``binning.py:232-362``).

    Stage A expands each gaussian into one source per tile row of its rect
    (extras form of K3; the row index rides the walk's k, the extras carry
    the f32 attributes).  Per row band the surviving tile columns form one
    contiguous x-range (the sublevel set {q <= tau} is convex), computed in
    closed form from the projection of ellipse-intersect-band; the per-tile
    histogram deposits +-1 at the clipped row endpoints, and stage B runs
    the no-extras expansion over the row sources with clipped widths.
    The float operations follow the JAX order, one float32 rounding each
    (the logarithm in ``tau`` may differ by an ulp between libraries), so
    the survivor sets are the JAX package's (the CPU tests hold every
    output field bit-equal)."""
    P = pre.depths.shape[0]
    num_tiles = grid_x * grid_y
    dev = pre.depths.device
    i32 = dict(dtype=torch.int32, device=dev)
    if I % EXPAND_CHUNK != 0:
        raise ValueError(f"cull='exact' needs max_instances a multiple of "
                         f"{EXPAND_CHUNK}, got {I}")
    IR = row_capacity(I, max_rows)
    if not (P < (1 << 24) and I < (1 << 24)):
        raise ValueError("cull='exact' needs fewer than 2^24 gaussians and "
                         "instance slots (the JAX kernel's f32 carrier)")
    rw_cap, rw_bits, pack_meta = meta_layout(grid_x, num_tiles, align)
    rs = row_sources(pre, grid_x, grid_y, align)
    ty_r, gid_r, ext = expand(rs.offsets, rs.meta, rs.gid, IR, rw_bits,
                              grid_x, grid_y, extras=rs.extras)
    mx, my, ca, cb, cc, tau_r, rx0, rwg = ext
    f32 = torch.float32

    # ---- exact per-row x-range (projection of ellipse ∩ row band) ---------
    ca_g = torch.clamp(ca, min=1e-12)
    cc_g = torch.clamp(cc, min=1e-12)
    tyf = ty_r.to(f32)
    l = float(TILE_Y) * tyf - my
    h = l + float(TILE_Y - 1)
    abar = torch.clamp(ca_g - cb * cb / cc_g, min=1e-12)
    cbar = torch.clamp(cc_g - cb * cb / ca_g, min=1e-12)
    # jnp.clip(0.0, l, h): the scalar 0 clamped into [l, h]
    dyc = torch.minimum(torch.clamp(l, min=0.0), h)
    nonempty = 0.5 * cbar * dyc * dyc <= tau_r
    dx_e = torch.sqrt(2.0 * torch.clamp(tau_r, min=0.0) / abar)

    def edge_root(e, sign):
        disc = torch.clamp(
            cb * cb * e * e - ca_g * (cc_g * e * e - 2.0 * tau_r), min=0.0)
        return (-cb * e + sign * torch.sqrt(disc)) / ca_g

    dy_hi = -cb * dx_e / cc_g
    dx_hi = torch.where((dy_hi >= l) & (dy_hi <= h), dx_e,
                        edge_root(torch.where(dy_hi < l, l, h), 1.0))
    dy_lo = cb * dx_e / cc_g
    dx_lo = torch.where((dy_lo >= l) & (dy_lo <= h), -dx_e,
                        edge_root(torch.where(dy_lo < l, l, h), -1.0))
    X_lo = torch.maximum(
        torch.ceil((mx + dx_lo - float(TILE_X - 1)) / float(TILE_X)), rx0)
    X_hi = torch.minimum(torch.floor((mx + dx_hi) / float(TILE_X)),
                         rx0 + rwg - 1.0)
    widthf = torch.where(nonempty & (gid_r < P), X_hi - X_lo + 1.0, 0.0)
    width = torch.clamp(widthf, min=0.0).to(torch.int32)
    # X_lo is cast only where the row survives (elsewhere it may be inf/nan)
    X_lo_i = torch.where(width > 0, X_lo, 0.0).to(torch.int32)

    # ---- per-tile survivor counts: row-range difference histogram ---------
    W2 = grid_x + 1
    dump = grid_y * W2
    posR = torch.where(width > 0, ty_r * W2 + X_lo_i, dump)
    negR = torch.where(width > 0, ty_r * W2 + X_lo_i + width, dump)
    h2 = torch.zeros(dump + 1, **i32)
    h2.scatter_add_(0, posR.long(), torch.ones_like(posR))
    h2.scatter_add_(0, negR.long(), torch.full_like(negR, -1))
    counts = torch.cumsum(h2[:dump].view(grid_y, W2), dim=1)[:, :grid_x]
    counts = counts.reshape(-1).to(torch.int32)                    # [T]

    pads = torch.remainder(-counts, align)
    padded = counts + pads
    tile_start = _exclusive_cumsum(padded)
    num_rendered = torch.sum(width, dtype=torch.int32)
    total_padded = num_rendered + torch.sum(pads, dtype=torch.int32)
    overflow = (total_padded > I) | (rs.rows_total > IR)

    # ---- stage B: no-extras expansion over the clipped row sources --------
    offB = _exclusive_cumsum(width)
    metaB = pack_meta(ty_r * grid_x + X_lo_i, torch.clamp(width, min=1),
                      torch.ones_like(width))
    offsets_pad = num_rendered + _exclusive_cumsum(pads)
    all_offsets = torch.cat([offB, offsets_pad, total_padded.reshape(1)])
    all_meta = torch.cat([metaB, _pad_and_tail_meta(num_tiles, align, rw_cap,
                                                    pack_meta, dev)])
    all_gid = torch.cat([gid_r, torch.full((num_tiles + 1,), P, **i32)])
    tile, gid = expand(all_offsets.contiguous(), all_meta.contiguous(),
                       all_gid.contiguous(), I, rw_bits, grid_x, num_tiles)
    return _sorted_bins(tile, gid, tile_start, counts, num_rendered,
                        total_padded, overflow)


def _sorted_bins(tile, gid, tile_start, counts, num_rendered, num_padded,
                 overflow) -> BinningOut:
    """Instances are already in depth order and pads follow every real
    instance, so one stable sort on the tile id finishes the
    (tile, depth, pads-last) order."""
    tile_s, perm = torch.sort(tile, stable=True)
    return BinningOut(gauss_id=gid[perm], tile_id=tile_s,
                      tile_start=tile_start, tile_count=counts,
                      num_rendered=num_rendered, num_padded=num_padded,
                      overflow=overflow)


def bin_gaussians(pre: PreprocessOut, grid_x: int, grid_y: int,
                  max_instances: int, align: int = 128,
                  cull: str = "none", max_rows: int = 0) -> BinningOut:
    """The expansions run through the K3 wrapper: the kernel on a CUDA
    tensor, its plain version on a CPU one.  ``cull="exact"`` drops every
    (gaussian, tile) instance whose ellipse {q <= ln(255*op)} provably
    misses the tile: the images are the same (the composite skips every
    pixel of such an instance) from fewer instances; it needs
    ``max_instances`` a multiple of 1024 and a row capacity ``max_rows``
    (0 = half of ``max_instances``)."""
    num_tiles = grid_x * grid_y
    I = max_instances
    if I % align != 0:
        raise ValueError("max_instances must be a multiple of align")
    if cull == "exact":
        return _bin_gaussians_culled(pre, grid_x, grid_y, I, align, max_rows)
    if cull != "none":
        raise ValueError(f"cull must be 'none' or 'exact', got {cull!r}")

    src = expansion_sources(pre, grid_x, grid_y, align)
    tile, gid = expand(src.offsets, src.meta, src.gid, I, src.rw_bits, grid_x,
                       num_tiles)
    return _sorted_bins(tile, gid, src.tile_start, src.counts,
                        src.num_rendered, src.num_padded, src.num_padded > I)
