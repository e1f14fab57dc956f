"""Tile binning: duplicate gaussians per touched tile, sort by (tile, depth),
find per-tile ranges with ALIGN-aligned per-tile segments.

PyTorch port of ``gsplat_tpu/ops/binning.py`` on its ``cull="none"`` path
(see that module for the design).  In order:

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

Everything has a fixed capacity ``max_instances``; overflow is reported,
never an out-of-bounds write.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops.preprocess import PreprocessOut


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

    # depth-major gaussian order on the int32 bits of the view depth
    depth_bits_g = pre.depths.to(torch.float32).view(torch.int32)
    dkey = torch.where(pre.visible, depth_bits_g, 0x7FFFFFFF)
    order = torch.argsort(dkey, stable=True).to(torch.int32)       # [P]

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
    rw_cap = max(grid_x, align, 2)
    rw_bits = int(rw_cap).bit_length()
    base_bits = int(num_tiles).bit_length()
    if 1 + rw_bits + base_bits > 31:
        raise ValueError("tile grid too large for the packed meta word")

    def pack_meta(base, rw, colstep):
        return ((base << (rw_bits + 1)) | (rw << 1) | colstep).to(torch.int32)

    base_real = src_tbl[:, 2] * grid_x + src_tbl[:, 1]
    meta_real = pack_meta(base_real, src_tbl[:, 3], torch.ones_like(base_real))
    tids = torch.arange(num_tiles, **i32)
    meta_pad = pack_meta(tids, torch.full_like(tids, align if align > 1 else 1),
                         torch.zeros_like(tids))
    meta_tail = torch.tensor([(num_tiles << (rw_bits + 1)) | (rw_cap << 1)],
                             **i32)
    return ExpansionSources(
        offsets=torch.cat([offsets_real, offsets_pad,
                           total_padded.reshape(1)]).contiguous(),
        meta=torch.cat([meta_real, meta_pad, meta_tail]).contiguous(),
        gid=torch.cat([order, torch.full((num_tiles + 1,), P, **i32)]
                      ).contiguous(),
        rw_bits=rw_bits,
        counts=counts,
        tile_start=tile_start,
        num_rendered=num_rendered,
        num_padded=total_padded,
    )


def expand_plain(offsets, meta, gid, I: int, rw_bits: int, grid_x: int,
                 num_tiles: int):
    """Plain PyTorch version of K3: the owner of slot i is the last source
    with offset <= i (``searchsorted(..., right=True) - 1``), then the same
    decode as the kernel."""
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
    return (torch.clamp(tile, max=num_tiles).to(torch.int32),
            gid[src].to(torch.int32))


def expand(offsets, meta, gid, I: int, rw_bits: int, grid_x: int,
           num_tiles: int):
    """K3 wrapper: ``(tile [I], gid [I])`` int32 for the packed sources.
    A CPU tensor goes to ``expand_plain``; a CUDA tensor launches
    ``csrc/expand.cu``."""
    dev = offsets.device
    S = offsets.shape[0]
    for name, t in (("offsets", offsets), ("meta", meta), ("gid", gid)):
        _kernels.check_int32_vector(name, t, dev, S)
    _kernels.require(I > 0, f"capacity I must be positive, got {I}")
    if dev.type == "cpu":
        return expand_plain(offsets, meta, gid, I, rw_bits, grid_x, num_tiles)
    _kernels.require(dev.type == "cuda", f"unsupported device {dev}")
    tile = torch.empty(I, dtype=torch.int32, device=dev)
    gid_out = torch.empty(I, dtype=torch.int32, device=dev)
    lib = _kernels.lib()
    with torch.cuda.device(dev):
        err = lib.gsplat_expand(
            offsets.data_ptr(), meta.data_ptr(), gid.data_ptr(), S, I,
            rw_bits, grid_x, num_tiles, tile.data_ptr(), gid_out.data_ptr(),
            _kernels.stream_of(offsets))
    _kernels.check(err, "expand")
    _kernels.launch_counts["expand"] += 1
    return tile, gid_out


def bin_gaussians(pre: PreprocessOut, grid_x: int, grid_y: int,
                  max_instances: int, align: int = 128,
                  cull: str = "none") -> BinningOut:
    """The expansion runs through the K3 wrapper: the kernel on a CUDA
    tensor, its plain version on a CPU one."""
    if cull != "none":
        raise NotImplementedError(
            f"cull={cull!r}: exact-cull binning (and the extras form of K3 "
            "it needs) is not ported yet; see ROADMAP.md, Queue 1")
    num_tiles = grid_x * grid_y
    I = max_instances
    if I % align != 0:
        raise ValueError("max_instances must be a multiple of align")

    src = expansion_sources(pre, grid_x, grid_y, align)
    tile, gid = expand(src.offsets, src.meta, src.gid, I, src.rw_bits, grid_x,
                       num_tiles)

    # instances are already in depth order and pads follow every real
    # instance, so one stable sort on the tile id finishes the
    # (tile, depth, pads-last) order
    tile_s, perm = torch.sort(tile, stable=True)
    return BinningOut(
        gauss_id=gid[perm],
        tile_id=tile_s,
        tile_start=src.tile_start,
        tile_count=src.counts,
        num_rendered=src.num_rendered,
        num_padded=src.num_padded,
        overflow=src.num_padded > I,
    )
