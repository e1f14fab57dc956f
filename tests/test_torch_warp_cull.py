"""K1's and K2's per-warp cull, K1's pairs after it, and K4's segment bounds,
on the CPU: the plain versions of what the kernels compute.

``warps_that_may_composite_plain`` is the cull in torch with the kernel's
margin; it must keep every warp that holds a pixel K1's plain version
composites.  ``segment_bounds_plain`` is K4's first pass; it must give each
segment's first row as ``torch.searchsorted`` does.  ``k1_culled_pairs``
counts what K1 tests after the cull; it must agree with a walk written out
pixel by pixel."""
import math

import numpy as np
import torch

from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import composite_cuda as tcomp
from gsplat_tpu_torch.ops import preprocess as tpre
from gsplat_tpu_torch.ops.composite_ref import ALPHA_MIN
from gsplat_tpu_torch.ops.segment_reduce import segment_bounds_plain
from gsplat_tpu_torch.tools import workload as wl

from torch_helpers import GAUSS_KEYS, cam_np, make_camera, make_gaussians_np


def _scene(seed, n=300, W=64, H=64, scale=1.0):
    """K1's inputs for a seeded cloud of ``n`` gaussians at W x H (C = 5:
    rgb, depth, ones)."""
    rng = np.random.default_rng(seed)
    g = make_gaussians_np(rng, n=n, spread=0.9)
    g["scales"] *= scale
    c = cam_np(make_camera(W, H))
    ta = [torch.from_numpy(np.array(g[k])) for k in GAUSS_KEYS] + [
        torch.from_numpy(np.array(c[k]))
        for k in ("viewmatrix", "projmatrix", "campos")]
    pre = tpre.preprocess(*ta[:5], 3, *ta[5:], c["tan_fovx"], c["tan_fovy"],
                          W, H)
    gx = (W + tpre.TILE_X - 1) // tpre.TILE_X
    gy = (H + tpre.TILE_Y - 1) // tpre.TILE_Y
    bins = tbin.bin_gaussians(pre, gx, gy, 1 << 14)
    assert not bool(bins.overflow)
    ones = torch.ones_like(pre.depths[:, None])
    table = torch.cat([pre.means2d, pre.conic, pre.opacity[:, None], pre.rgb,
                       pre.depths[:, None], ones], dim=1).contiguous()
    starts, counts = tcomp.tile_ranges(bins)
    return table, bins.gauss_id.contiguous(), starts, counts, gx


def _composited_outside_cull(table, gid, starts, counts, gx, form):
    """(pairs K1's plain version composites, those of them in a warp whose
    cull bit is clear, (instance, warp) bits the cull clears)."""
    out = tcomp.composite_forward_plain(table, gid, starts, counts, gx, form)
    C = table.shape[1] - tcomp.ATTR_BASE
    n_contrib = out[:, C + 1].long()
    P = table.shape[0]
    table_p = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    warp_of = tcomp.pixel_warps()
    nwarps = int(warp_of.max()) + 1
    tiles = torch.arange(starts.shape[0])
    px, py = tcomp.pixel_coords(tiles, gx)
    basis = tcomp.tile_basis(tiles, gx)
    ox, oy = basis[0], basis[1]
    cut = tcomp.QUAD_POWER_CUT if form.mxu_power else 0.0
    composited = missed = cleared = 0
    for c0 in range(0, int(counts.max()), tcomp.CHUNK):
        pos = c0 + torch.arange(tcomp.CHUNK)
        rows, valid, _ = tcomp._instance_rows(table_p, gid, starts, counts,
                                              pos, P)
        _, _, power, raw = tcomp.pair_terms(
            rows, px, py, basis if form.mxu_power else None)
        alpha = torch.clamp(raw, max=tcomp.ALPHA_MAX)
        comp_ = (valid[:, :, None] & (power <= cut) & (alpha >= ALPHA_MIN)
                 & (pos[None, :, None] < n_contrib[:, None, :]))
        may = tcomp.warps_that_may_composite_plain(rows, ox, oy, valid)
        bits = ((may[:, :, None] >> torch.arange(nwarps)) & 1).bool()
        composited += int(comp_.sum())
        missed += int((comp_ & ~bits[:, :, warp_of]).sum())
        cleared += int((valid[:, :, None] & ~bits).sum())
    return composited, missed, cleared


def test_cull_keeps_every_composited_pair():
    """On a seeded 64x64 scene of 300 gaussians, in the f32 and the quad
    form: every (pixel, instance) pair that ``composite_forward_plain``
    composites lies in a warp whose bit the cull sets, and the cull clears
    most of the (instance, warp) bits."""
    scene = _scene(11)
    for form in (tcomp.F32, tcomp.Form(mxu_power=True)):
        composited, missed, cleared = _composited_outside_cull(*scene, form)
        assert composited > 10000, form
        assert missed == 0, form
        assert cleared > 1000, form


def test_cull_edge_cases():
    """Hand-made rows in one 32x32 tile, among pad sentinels: means on a
    pixel centre with opacity 1/255 (composited at that pixel alone),
    near-degenerate and non-positive-definite conics, opacity 0, NaN and
    inf geometry, means outside the tile; every composited pair keeps its
    warp, and each kind of row gets the bits the kernel gives it."""
    rng = np.random.default_rng(5)
    rows = []
    T = tcomp.TILE_X
    op_min = np.float32(1.0 / 255.0)
    for x, y in ((3, 4), (20, 30), (31, 0)):      # opacity at the threshold
        rows.append([x, y, 0.5, 0.0, 0.5, op_min])
    for _ in range(8):                              # near-degenerate conics
        a, c = rng.uniform(0.01, 2.0, 2)
        b = math.sqrt(a * c) * (1 - 1e-6) * rng.choice([-1, 1])
        rows.append([*rng.uniform(-8, T + 8, 2), a, b, c,
                     rng.uniform(0.1, 1.0)])
    for _ in range(4):                              # not positive definite
        rows.append([*rng.uniform(0, T, 2), 0.1, 0.5, 0.1, 0.9])
    rows.append([10.0, 10.0, 0.2, 0.0, 0.2, 0.0])   # opacity 0
    rows.append([float("nan"), 10.0, 0.2, 0.0, 0.2, 0.9])
    rows.append([10.0, 10.0, float("inf"), 0.0, 0.2, 0.9])
    for _ in range(12):                             # means outside the tile
        ang = rng.uniform(0, 2 * math.pi)
        rad = rng.uniform(T, 3 * T)
        rows.append([T / 2 + rad * math.cos(ang), T / 2 + rad * math.sin(ang),
                     rng.uniform(0.002, 0.02), 0.0,
                     rng.uniform(0.002, 0.02), rng.uniform(0.3, 1.0)])
    geo = torch.tensor(rows, dtype=torch.float32)
    P = geo.shape[0]
    feats = torch.from_numpy(rng.uniform(0.1, 1.0, (P, 3)).astype(np.float32))
    table = torch.cat([geo, feats], dim=1).contiguous()
    # the instance list: every row, with pad sentinels (id P) in between
    gid = torch.tensor([g for i in range(P) for g in ((i, P) if i % 5 == 2
                                                     else (i,))],
                       dtype=torch.int32)
    starts = torch.zeros(1, dtype=torch.int32)
    counts = torch.tensor([gid.shape[0]], dtype=torch.int32)
    for form in (tcomp.F32, tcomp.Form(mxu_power=True)):
        composited, missed, _ = _composited_outside_cull(
            table, gid, starts, counts, 1, form)
        assert composited > 0 and missed == 0, form
    # the pixel at the threshold opacity's mean is composited, its warp kept
    out = tcomp.composite_forward_plain(table[:1], torch.tensor([0],
                                        dtype=torch.int32), starts,
                                        torch.tensor([1], dtype=torch.int32), 1)
    assert int((out[0, 3 + 1] > 0).sum()) == 1
    full = (1 << len(tcomp.warp_boxes())) - 1
    zero = torch.zeros((1, 1))
    may = tcomp.warps_that_may_composite_plain(geo[None], zero, zero)[0]
    real = torch.ones((1, P), dtype=torch.bool)
    real[0, 0] = False
    assert int(tcomp.warps_that_may_composite_plain(
        geo[None], zero, zero, real)[0, 0]) == 0            # the sentinel
    n_deg = 3 + 8
    assert all(int(m) == full for m in may[n_deg:n_deg + 4])  # not PD
    assert int(may[n_deg + 4]) == 0                          # opacity 0
    assert int(may[n_deg + 5]) == full and int(may[n_deg + 6]) == full
    warp0 = int(tcomp.pixel_warps()[4 * T + 3])
    assert (int(may[0]) >> warp0) & 1 and int(may[0]) != full


def test_segment_bounds_plain_matches_searchsorted():
    """K4's first pass in torch: pads (ids past num_segments, the sentinel
    among them), negative ids, empty segments, empty input, every row
    padded, and no segments at all."""
    rng = np.random.default_rng(3)
    cases = []
    ids = np.sort(rng.integers(0, 40, 300))
    cases.append((np.concatenate([ids, np.full(25, 50)]), 50))   # empty runs
    cases.append((np.concatenate([[-4, -1], ids, [60, 60]]), 45))
    cases.append((np.array([], np.int64), 7))                    # no rows
    cases.append((np.full(9, 12), 12))                           # all padded
    cases.append((ids, 0))                                       # no segments
    cases.append((np.array([5, 5, 5]), 6))
    for ids, ns in cases:
        sids = torch.from_numpy(ids.astype(np.int32))
        got = segment_bounds_plain(sids, ns)
        want = torch.searchsorted(sids.long(), torch.arange(ns + 1))
        assert got.shape == (ns + 1,)
        assert torch.equal(got, want), (ids[:10], ns)


def _culled_pairs_by_hand(table, gid, starts, counts, gx):
    """K1's walk after the cull written out: each pixel's recurrence run
    instance by instance, each warp walking up to its last pixel's stop and
    testing the boxes of the instances whose bits it needs; and the
    instances each CTA of K1's split stages."""
    P = table.shape[0]
    C = table.shape[1] - tcomp.ATTR_BASE
    warp_of = tcomp.pixel_warps()
    nwarps = int(warp_of.max()) + 1
    cta_of = tcomp.forward_ctas()
    boxes = tcomp.warp_boxes()
    n = dict.fromkeys(("tested", "live", "warp_instances", "composited",
                       "stopping", "staged", "masks", "mask_edges"), 0)
    limits = []
    for t in range(starts.shape[0]):
        px, py = tcomp.pixel_coords(torch.tensor([t]), gx)
        ox, oy = tcomp.tile_basis(torch.tensor([t]), gx)[:2]
        Tr = torch.ones(tcomp.TILE_PIX)
        done = torch.zeros(tcomp.TILE_PIX, dtype=torch.bool)
        last = torch.full((tcomp.TILE_PIX,), int(counts[t]) - 1)
        bits, boxed, mean = [], [], []
        for k in range(int(counts[t])):
            g = int(gid[int(starts[t]) + k])
            real = 0 <= g < P
            row = table[g] if real else torch.zeros(6 + C)
            _, _, power, raw = tcomp.pair_terms(row[None, None], px, py)
            alpha = torch.clamp(raw[0, 0], max=tcomp.ALPHA_MAX)
            ok = real & (power[0, 0] <= 0) & (alpha >= ALPHA_MIN) & ~done
            test_T = Tr * (1.0 - alpha)
            stop = ok & (test_T < 1e-4)
            n["composited"] += int((ok & ~stop).sum())
            last = torch.where(stop, torch.tensor(k), last)
            done |= stop
            Tr = torch.where(ok & ~stop, test_T, Tr)
            may = int(tcomp.warps_that_may_composite_plain(
                row[None, None], ox, oy, torch.tensor([[real]]))[0, 0])
            bits.append([(may >> w) & 1 for w in range(nwarps)])
            mx, my, a, b, c, op = (float(v) for v in row[:6])
            boxed.append(real and a > 0 and c > 0 and a * c - b * b > 0
                         and all(math.isfinite(v) for v in (mx, my, a, b, c))
                         and op > 0)
            mean.append((mx - float(ox), my - float(oy)))
        n["stopping"] += int(done.sum())
        if counts[t] > 0:
            n["staged"] += sum(0 <= int(gid[int(starts[t]) + k]) < P
                               for k in range(int(last.max()) + 1))
        for w in range(nwarps):
            pix = (warp_of == w).nonzero().flatten()
            wl_ = int(last[pix].max()) if counts[t] > 0 else -1
            x0, x1, y0, y1 = boxes[w]
            for k in range(int(counts[t])):
                if k > wl_:
                    continue
                if boxed[k]:
                    n["masks"] += 1
                    xr, yr = mean[k]
                    n["mask_edges"] += not (x0 <= xr <= x1 and y0 <= yr <= y1)
                if bits[k][w]:
                    n["warp_instances"] += 1
                    n["tested"] += pix.shape[0]
                    n["live"] += int((last[pix] >= k).sum())
        lim = []
        for s in range(int(cta_of.max()) + 1):
            m = cta_of == s
            whole = int(counts[t])
            lim.append(min(whole, (int(last[m].max()) // 128 + 1) * 128)
                       if bool(done[m].all()) else whole)
        limits.append(lim)
    return n, torch.tensor(limits, dtype=torch.int32)


def test_k1_culled_pair_counts_match_a_walk_by_hand():
    """``workload.k1_culled_pairs`` on a seeded 64x32 scene of 150 larger
    gaussians, where pixels terminate part-way, against the walk written
    out instance by instance (the pairs, the cull's boxes and the instances
    K1's bound counts); before the cull, ``k1_pair_counts``' tested pairs
    are the walk's pixels up to their own stop, and its limits the
    instances each of K1's CTAs stages."""
    table, gid, starts, counts, gx = _scene(21, n=150, W=64, H=32, scale=4.0)
    C = table.shape[1] - tcomp.ATTR_BASE
    out = tcomp.composite_forward_plain(table, gid, starts, counts, gx)
    got = wl.k1_culled_pairs(table, gid, starts, counts, gx, out[:, C + 1])
    want, limits = _culled_pairs_by_hand(table, gid, starts, counts, gx)
    assert got == want
    assert 0 < want["mask_edges"] < want["masks"]
    before = wl.k1_pair_counts(table, gid, starts, counts, gx, out[:, C + 1])
    assert want["live"] < before["tested"]
    assert before["stopping"] == want["stopping"] > 0
    assert before["composited"] == want["composited"]
    assert torch.equal(before["limits"], limits)
