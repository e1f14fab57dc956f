"""Inputs of the kernel probes, the (pixel, instance) pairs they need, and
their bounds.

``asset_workload`` builds K1's and K2's real inputs at the 1080p asset
through the port's own stages (preprocess, binning with K3, the attribute
table, K1), the inputs ``chip_smoke.py`` checks the kernels on.
``synthetic_workload`` is ``tools/bench_dma_overhead.py::make_workload``
(:51) in the port's tile layout, from the same numpy draws.  The pair
counts are what the bounds count: the work these inputs need, not the most
they could.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from gsplat_tpu_torch.ops.binning import meta_layout
from gsplat_tpu_torch.ops import composite_cuda as comp
from gsplat_tpu_torch.ops import segment_reduce as seg
from gsplat_tpu_torch.ops.composite_ref import ALPHA_MIN
from gsplat_tpu_torch.tools.probes import TILES_PER_CTA

W, H = 1920, 1080
NUM_CLASS = 2
ASSET = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "assets", "trained_scene_big.npz")
CHUNK_TPU = 128          # composite_pallas.CHUNK: make_workload's chunk

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12       # fp32 outside the tensor cores
# bf16 outside the tensor cores (NVIDIA's H100 architecture whitepaper, SXM5:
# twice the fp32 rate, as packed pairs); the data sheet's 989e12 is the
# tensor cores' rate, which elementwise math cannot reach.
BF16_OPS_PER_S = 133.8e12
# Base-2 exponentials (MUFU.EX2 on the special function units): 16 results
# a clock an SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput, "32-bit floating-point base-2
# exponential"), 132 SMs at the 1980 MHz SM clock.  exp2f, expf and h2exp
# (two ex2.approx.f32 a bf16 pair) all issue there, apart from the fp32 pipe.
SFU_RESULTS_PER_S = 132 * 16 * 1.98e9

# fp32 operations of K1 (csrc/composite_fwd.cuh) per (pixel, instance) pair,
# exp2 counted as one: a tested pair takes dx, dy (2), power (9), the exp2
# argument, exp2, opacity product and cap (4) and the two skip tests (2); a
# pair that passes them takes test_T and its compare (3); a composited pair
# also takes alpha*T and a multiply and an add per channel (1 + 2C).
K1_TEST_OPS = 17
K1_STEP_OPS = 3
# fp32 operations of K2 (csrc/composite_bwd.cuh) per (pixel, instance) pair: a
# tested pair (every position up to the pixel's n_contrib) takes K1's 17 and
# the n_contrib gate (1); a composited pair also takes g (2C), w (1), the
# prefix (2), the suffix (1), d alpha (5), the cap test and dpow (2), the
# five moment products (5), the T update (2), the feature products (Cg) and
# one add per summed value (6 + Cg): 24 + 2C + 2Cg.
K2_TEST_OPS = 18
# Integer operations of the packed forms (feat_precision="bf16"): staging
# unpacks each stored feature of a staged real instance with a mask or a
# shift and the select between them (2); K2 packs each pair word of a row it
# writes from two sums, each rounded by _round_bf16_bits' shift, mask, two
# adds and a mask (5), then a shift and an or (12 a word).
UNPACK_OPS = 2
PACK_OPS = 12
# fp32 operations of the per-warp cull (composite_common.cuh::
# warps_that_may_composite) that K1's bound counts: per real instance a tile
# needs, the conic's and the values' tests and op > 0 (12), the
# tile-relative mean and the span (6) and the limit with its margin (11);
# per instance and warp that needs its bit, of an instance that passes those
# tests, the box's four offsets, the test that the box holds the mean and
# the final compare (9), and where it does not hold the mean the four edge
# minima of quad_min_box (15 each).  The quad forms' coefficients
# (quad_coefficients) take 20 per real instance a tile needs.
CULL_INSTANCE_OPS = 29
CULL_WARP_OPS = 9
CULL_EDGE_OPS = 60
QUAD_COEF_OPS = 20
# Integer operations of one slot's decode in K3 and K3x (csrc/expand.cu),
# counted at the fp32 rate: k, the three meta fields, the quotient counted
# as one, the tile and its clamp.  How a kernel finds each slot's owner (a
# partition of the merge, a binary search) is a cost of its design, not of
# expansion, and is not counted.
K3_DECODE_OPS = 12


def k2_pair_ops(C, Cg):
    return 24 + 2 * C + 2 * Cg


def bound_ms(nbytes, nops, ops_per_s=FP32_OPS_PER_S, nexp=0):
    """(ms, "bytes", "operations" or "exponentials"): the largest of the
    bytes over the HBM rate, the operations over ``ops_per_s`` and the
    ``nexp`` exponentials over the SFU rate, and which one it is."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "operations": nops / ops_per_s * 1e3,
             "exponentials": nexp / SFU_RESULTS_PER_S * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], by


@dataclass
class Workload:
    """K1's and K2's inputs: the [P, 6+C] table, the sorted instance list
    with per-tile starts and counts, a packed [T, C+2, TILE_PIX] array for
    K2 and a cotangent of its shape; ``packed_is_k1`` says whether
    ``packed`` is K1's own output on these inputs (else K2 reads it as it
    is, as the synthetic workload's random one); ``scene`` holds the asset's
    intermediate stages (model, camera, preprocess output, binning) when
    there is one."""
    table: torch.Tensor
    gauss_id: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    grid_x: int
    packed: torch.Tensor
    d_packed: torch.Tensor
    Cg: int
    name: str
    packed_is_k1: bool = False
    scene: dict = field(default_factory=dict)
    pairs: Optional[dict] = None
    culled: Optional[dict] = None

    @property
    def C(self) -> int:
        return self.table.shape[1] - comp.ATTR_BASE

    @property
    def k1_args(self):
        return (self.table, self.gauss_id, self.starts, self.counts,
                self.grid_x)

    @property
    def k2_args(self):
        return (*self.k1_args, self.packed, self.d_packed, self.Cg)


def asset_model(device="cuda"):
    """(model, camera): ``assets/trained_scene_big.npz`` (262,046
    gaussians, SH degree 3) with num_class=2 segment logits from
    ``numpy.random.default_rng(0)``, and bench.py's 1920x1080 camera (R = I,
    T = [0, 0.6, 4.2], FoVx 62 degrees)."""
    from gsplat_tpu_torch.core.cameras import Camera
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.models.gaussians import GaussianModel

    dev = resolve_device(device)
    model = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device=dev)
    model.load_npz(ASSET)
    P = model.capacity
    seg = np.random.default_rng(0).standard_normal((P, NUM_CLASS))
    model.params = model.params._replace(
        segment=torch.from_numpy(seg.astype(np.float32)).to(dev))
    fovx = math.radians(62.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.6, 4.2]),
                 FoVx=fovx, FoVy=fovy, image=np.zeros((3, H, W), np.float32),
                 image_name="bench", uid=0)
    return model, cam


def asset_workload(device="cuda", pair_counts: bool = True) -> Workload:
    """K1's and K2's inputs at the 1080p asset: ``assets/
    trained_scene_big.npz`` (262,046 gaussians, SH degree 3) with num_class=2
    segment logits from ``numpy.random.default_rng(0)``, at bench.py's
    1920x1080 camera (R = I, T = [0, 0.6, 4.2], FoVx 62 degrees), binned at
    the renderer's capacity, C = 7 channels (rgb, depth, 2 segments, ones);
    K1's output on these inputs and a cotangent from a generator seeded 2
    (Cg = 6: the ones channel gets none).  ``pair_counts`` adds K1's pair
    counts (``k1_pair_counts``, and after the cull ``k1_culled_pairs``)
    from K1's own n_contrib."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.device import resolve_device
    from gsplat_tpu_torch.ops import binning as bin_lib
    from gsplat_tpu_torch.ops import preprocess as pre_lib

    dev = resolve_device(device)
    model, cam = asset_model(dev)
    gx = (W + pre_lib.TILE_X - 1) // pre_lib.TILE_X
    gy = (H + pre_lib.TILE_Y - 1) // pre_lib.TILE_Y
    cap = renderer._auto_capacity(cam, model, W, H, 1.0)
    p = model.params
    mats = [torch.as_tensor(m, device=dev) for m in (
        cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    pre_args = (p.xyz, T.scaling_activation(p.scaling), p.rotation,
                T.opacity_activation(p.opacity[:, 0]), model.get_features, 3,
                *mats, cam.tan_fovx, cam.tan_fovy, W, H)
    pre = pre_lib.preprocess(*pre_args)
    bins = bin_lib.bin_gaussians(pre, gx, gy, cap)
    feats = torch.cat([pre.rgb, pre.depths[:, None],
                       T.segment_activation(p.segment),
                       torch.ones_like(pre.depths[:, None])], dim=1)
    table = torch.cat([pre.means2d, pre.conic, pre.opacity[:, None], feats],
                      dim=1).contiguous()
    starts, counts = comp.tile_ranges(bins)
    gid = bins.gauss_id.contiguous()
    packed = comp.composite_forward(table, gid, starts, counts, gx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    d_packed = torch.randn(packed.shape, generator=gen, device=dev)
    w = Workload(table, gid, starts, counts, gx, packed, d_packed,
                 Cg=feats.shape[1] - 1, name="asset", packed_is_k1=True,
                 scene=dict(model=model, cam=cam, pre=pre, pre_args=pre_args,
                            bins=bins, feats=feats, cap=cap, grid_y=gy))
    if pair_counts:
        w.pairs = k1_pair_counts(*w.k1_args, packed[:, w.C + 1])
        w.culled = k1_culled_pairs(*w.k1_args, packed[:, w.C + 1])
    return w


def synthetic_workload(grid_x=120, grid_y=68, mean_count=200, R=16, seed=0,
                       C=5, device="cuda") -> Workload:
    """``tools/bench_dma_overhead.py::make_workload`` (:51) in the port's
    layout, from the same draws: per-tile counts ~ N(mean_count, 80) cut at
    0, each tile's instances padded to 128-instance chunks laid end to end,
    attributes N(0, 1) * 0.01 as [chunks, R, 128].  Instance k of chunk c is
    table row 128 c + k (its first 6 + C of the R attributes), ``gauss_id``
    is the identity on the instances and the sentinel P on the pads, and
    tile t starts at its first chunk.  ``packed`` and ``d_packed`` are
    ``bench_bwd_attrib.py``'s (:221-225: uniform(0.1, 200) and N(0, 1) *
    0.01 from a generator seeded 1)."""
    from gsplat_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    T = grid_x * grid_y
    counts = np.maximum(0, rng.normal(mean_count, 80, T)).astype(np.int64)
    padded = (counts + CHUNK_TPU - 1) // CHUNK_TPU * CHUNK_TPU
    chunk0 = np.concatenate([[0], np.cumsum(padded // CHUNK_TPU)])[:-1]
    nch = int(np.sum(padded) // CHUNK_TPU)
    attr = rng.standard_normal((nch, R, CHUNK_TPU)).astype(np.float32) * 0.01
    P = nch * CHUNK_TPU
    table = attr.transpose(0, 2, 1).reshape(P, R)[:, :comp.ATTR_BASE + C]
    starts = chunk0 * CHUNK_TPU
    gid = np.full(P, P, np.int32)
    for s, n in zip(starts, counts):
        gid[s:s + n] = np.arange(s, s + n, dtype=np.int32)
    rng1 = np.random.default_rng(1)
    shape = (T, C + 2, comp.TILE_PIX)
    packed = rng1.uniform(0.1, 200, shape).astype(np.float32)
    d_packed = rng1.standard_normal(shape).astype(np.float32) * .01

    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    return Workload(t(table), t(gid), t(starts, torch.int32),
                    t(counts, torch.int32), grid_x, t(packed), t(d_packed),
                    Cg=C, name="synthetic")


def _tile_batches(table, starts, counts, grid_x):
    """Per batch of tiles: (slice, px, py [n, TILE_PIX], the table with its
    sentinel row P, positions [CHUNK]); batches keep each [n, CHUNK,
    TILE_PIX] temporary near 2^25 floats, as the plain versions do."""
    P, R = table.shape
    table_p = torch.cat([table, table.new_zeros((1, R))])
    ks = torch.arange(comp.CHUNK, dtype=torch.int64, device=table.device)
    tb = max(1, (1 << 25) // (comp.CHUNK * comp.TILE_PIX))
    for t0 in range(0, starts.shape[0], tb):
        t1 = min(starts.shape[0], t0 + tb)
        px, py = comp.pixel_coords(
            torch.arange(t0, t1, device=table.device), grid_x)
        yield slice(t0, t1), px, py, table_p, ks


def _pixel_stops(table, gauss_id, starts, counts, grid_x, n_contrib, quad):
    """Per batch of tiles (``_tile_batches``'): (slice, counts [n], stop
    [n, TILE_PIX], composited).  ``stop`` is each pixel's stopping position
    (the first instance at or after its n_contrib that passes the skip
    tests; int64 max where none does), ``composited`` the pairs before
    n_contrib that pass them."""
    P = table.shape[0]
    big = torch.iinfo(torch.int64).max
    cut = comp.QUAD_POWER_CUT if quad else 0.0
    for sl, px, py, table_p, ks in _tile_batches(table, starts, counts,
                                                 grid_x):
        cnt = counts[sl].long()
        nc = n_contrib[sl].long()                            # [n,PIX]
        stop = torch.full_like(nc, big)
        composited = 0
        basis = (comp.tile_basis(torch.arange(
            sl.start, sl.stop, device=table.device), grid_x)
            if quad else None)
        for c0 in range(0, int(cnt.max()), comp.CHUNK):
            if bool(((stop < big) | (cnt[:, None] <= c0)).all()):
                break
            pos = c0 + ks
            rows, valid, _ = comp._instance_rows(table_p, gauss_id, starts[sl],
                                                 counts[sl], pos, P)
            _, _, power, raw = comp.pair_terms(rows, px, py, basis)
            alpha = torch.clamp(raw, max=comp.ALPHA_MAX)
            passes = valid[:, :, None] & (power <= cut) & (alpha >= ALPHA_MIN)
            before = pos[None, :, None] < nc[:, None, :]
            composited += int((passes & before).sum())
            stop = torch.minimum(stop, torch.where(
                passes & ~before, pos[None, :, None], big).amin(dim=1))
        yield sl, cnt, stop, composited


def k1_pair_counts(table, gauss_id, starts, counts, grid_x, n_contrib,
                   quad=False):
    """K1's (pixel, instance) pairs on these inputs, given its per-pixel
    ``n_contrib`` [T, TILE_PIX] (1-based position of the last composited
    instance): dict(tested, composited, stopping, limits).  ``quad``: the
    skip tests of the mxu_power form (its power and its 1e-4 cut); the
    f32 [P, 6+C] table either way (the pairs see only its geometry).

    Before position n_contrib every instance that passes the skip tests is
    composited.  The first one that passes them after it stops the pixel;
    a pixel with none tests its whole tile.  ``tested`` counts each pixel's
    pairs up to its stop, the walk of one thread a pixel without the cull.
    ``limits`` [T, split] int32 is the number of instances each CTA of K1's
    tile split (``comp.forward_ctas``) stages: whole batches of
    ``_KERNEL_BATCH`` until every pixel of its warps has stopped."""
    big = torch.iinfo(torch.int64).max
    tested = composited = stopping = 0
    part = comp.forward_ctas().to(table.device)
    split = int(part.max()) + 1
    limits = counts[:, None].repeat(1, split)
    for sl, cnt, stop, comp_n in _pixel_stops(table, gauss_id, starts, counts,
                                              grid_x, n_contrib, quad):
        composited += comp_n
        found = stop < big
        stopping += int(found.sum())
        tested += int(torch.where(found, stop + 1, cnt[:, None]).sum())
        for s in range(split):
            f, st = found[:, part == s], stop[:, part == s]
            last_batch = torch.where(f, st, 0).amax(dim=1) \
                // comp._KERNEL_BATCH
            limits[sl, s] = torch.where(
                f.all(dim=1),
                torch.minimum(cnt, (last_batch + 1) * comp._KERNEL_BATCH),
                cnt).to(torch.int32)
    return dict(tested=tested, composited=composited, stopping=stopping,
                limits=limits.contiguous())


def k1_culled_pairs(table, gauss_id, starts, counts, grid_x, n_contrib,
                    quad=False):
    """The (pixel, instance) pairs K1's warps test after the cull, given its
    ``n_contrib`` (``k1_pair_counts``' arguments), and the rest of the work
    K1's bound counts (``k1_ops``): dict(tested, live, warp_instances,
    composited, stopping, staged, masks, mask_edges).  A warp walks its
    tile's instances up to the one where its last pixel stops (all of them
    if one never does) and tests the instances whose cull bit it has
    (``comp.warps_that_may_composite_plain``, the kernel's cull in torch):
    ``warp_instances`` counts those, ``tested`` their pairs (each of the
    warp's pixels inside the tile, done or not), and ``live`` the pairs of
    pixels not yet done, the pairs K1 tested before the cull that the cull
    keeps (a pixel tests up to its own stop).  ``composited`` and
    ``stopping`` are ``k1_pair_counts``'.  ``staged``: the real instances a
    tile needs, up to its last pixel's stop; ``masks``: the (instance, warp)
    pairs whose bit the warp needs (a real instance up to the warp's last
    one, whose conic and values pass the cull's first tests and whose
    opacity is positive, so that the warp's box is tested); ``mask_edges``:
    those whose box does not hold the gaussian's mean (quad_min_box takes
    its four edges)."""
    P = table.shape[0]
    big = torch.iinfo(torch.int64).max
    dev = table.device
    warp_of = comp.pixel_warps().to(dev)                     # [PIX]
    nwarps = int(warp_of.max()) + 1
    onehot = torch.nn.functional.one_hot(warp_of, nwarps).T.to(torch.int64)
    per_warp = onehot.sum(dim=1)                             # [W] pixels
    boxes = torch.tensor(comp.warp_boxes(), dtype=torch.float32,
                         device=dev)                         # [W,4]
    n = dict.fromkeys(("tested", "live", "warp_instances", "composited",
                       "stopping", "staged", "masks", "mask_edges"), 0)
    for sl, cnt, stop, comp_n in _pixel_stops(table, gauss_id, starts, counts,
                                              grid_x, n_contrib, quad):
        n["composited"] += comp_n
        n["stopping"] += int((stop < big).sum())
        last = torch.where(stop < big, stop, cnt[:, None] - 1)  # [n,PIX]
        # a warp's last instance: its pixels' latest stop
        wlast = torch.where(onehot[None].bool(), last[:, None, :],
                            -1).amax(dim=2)                  # [n,W]
        tiles = torch.arange(sl.start, sl.stop, device=dev)
        ox, oy, _, _ = comp.tile_basis(tiles, grid_x)
        table_p = torch.cat([table, table.new_zeros((1, table.shape[1]))])
        ks = torch.arange(comp.CHUNK, dtype=torch.int64, device=dev)
        for c0 in range(0, int(cnt.max()) if cnt.numel() else 0, comp.CHUNK):
            pos = c0 + ks
            rows, valid, _ = comp._instance_rows(table_p, gauss_id, starts[sl],
                                                 counts[sl], pos, P)
            may = comp.warps_that_may_composite_plain(rows, ox, oy, valid)
            bits = (may[:, :, None] >> torch.arange(nwarps, device=dev)) & 1
            bits = bits.bool() & valid[:, :, None]           # [n,K,W]
            w_need = pos[None, :, None] <= wlast[:, None, :]  # [n,K,W]
            w_on = bits & w_need
            n["warp_instances"] += int(w_on.sum())
            n["tested"] += int((w_on.long() * per_warp).sum())
            p_on = bits[:, :, warp_of] & (pos[None, :, None]
                                          <= last[:, None, :])
            n["live"] += int(p_on.sum())
            n["staged"] += int((valid & w_need.any(dim=2)).sum())
            mx, my, a, b, c, op = (rows[..., j] for j in range(6))
            boxed = (valid & (a > 0) & (c > 0) & (a * c - b * b > 0)
                     & torch.isfinite(rows[..., :5]).all(dim=-1) & (op > 0))
            need = boxed[:, :, None] & w_need
            xr, yr = (mx - ox)[:, :, None], (my - oy)[:, :, None]
            holds = ((xr >= boxes[:, 0]) & (xr <= boxes[:, 1])
                     & (yr >= boxes[:, 2]) & (yr <= boxes[:, 3]))
            n["masks"] += int(need.sum())
            n["mask_edges"] += int((need & ~holds).sum())
    return n


def walk_counts(table, gauss_id, starts, counts, grid_x):
    """The pairs of a walk over every instance of every tile (the probes
    without K1's termination): dict(all, passing, passing_no_exp): the pairs
    of real instances, those that pass K1's skip tests, and those that pass
    them with exp2 replaced by 1 + power."""
    P = table.shape[0]
    n_all = passing = passing_no_exp = 0
    for sl, px, py, table_p, ks in _tile_batches(table, starts, counts,
                                                 grid_x):
        cnt = counts[sl]
        for c0 in range(0, int(cnt.max()), comp.CHUNK):
            rows, valid, _ = comp._instance_rows(table_p, gauss_id, starts[sl],
                                                 cnt, c0 + ks, P)
            _, _, power, raw = comp.pair_terms(rows, px, py)
            ok = valid[:, :, None] & (power <= 0.0)
            n_all += int(valid.sum()) * comp.TILE_PIX
            passing += int((ok & (torch.clamp(raw, max=comp.ALPHA_MAX)
                                  >= ALPHA_MIN)).sum())
            lin = rows[:, :, 5, None] * (1.0 + power)
            passing_no_exp += int((ok & (torch.clamp(lin, max=comp.ALPHA_MAX)
                                         >= ALPHA_MIN)).sum())
    return dict(all=n_all, passing=passing, passing_no_exp=passing_no_exp)


def no_alpha_pairs(table, gauss_id, starts, counts, n_contrib):
    """Pairs P2's ``no_alpha`` composites: positions before each pixel's
    n_contrib whose instance is real and has opacity >= 1/255."""
    P = table.shape[0]
    g = gauss_id.long()
    ok = (g >= 0) & (g < P)
    op = table[:, 5][torch.where(ok, g, 0)]
    flag = (ok & (torch.clamp(op, max=comp.ALPHA_MAX) >= ALPHA_MIN)).long()
    pref = torch.cat([flag.new_zeros(1), torch.cumsum(flag, 0)])
    st = starts.long()[:, None]
    nc = torch.minimum(n_contrib.long(), counts.long()[:, None])
    return int((pref[st + nc] - pref[st]).sum())


def resident_ids(gauss_id, starts, counts, batch=comp._KERNEL_BATCH):
    """The instance list P3's ``compute_resident`` walks: position p of tile
    t reads the tile's instance p % batch (its first batch, resident)."""
    out = gauss_id.clone()
    cnt = counts.long()
    if int(cnt.sum()) == 0:
        return out
    tile = torch.repeat_interleave(torch.arange(cnt.shape[0],
                                                device=cnt.device), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(tile.shape[0], device=cnt.device) - first[tile]
    base = starts.long()[tile]
    out[base + pos] = gauss_id[base + pos % batch]
    return out


def form_of(name: str) -> "comp.Form":
    """K1's and K2's form by name ("f32", "quad", "packed", "packed_quad")
    at the asset's C = 7: the packed forms with the ones channel."""
    packed = "packed" in name
    return comp.Form(mxu_power="quad" in name, feat_packed=packed,
                     with_ones=packed)


def form_table(table, Cg: int, form) -> torch.Tensor:
    """A [P, 6+C] table in ``form``'s layout: packed, its Cg features as
    bf16 pairs after the geometry (the ones channel is made in the
    kernel)."""
    if not form.feat_packed:
        return table
    return torch.cat([table[:, :6], seg.pack_bf16_pairs(table[:, 6:6 + Cg])],
                     dim=1).contiguous()


def compare_form_rows(got, want, Cg: int, packed: bool):
    """K2's rule on a form's rows: each column within 1e-3 of its largest
    |value|; packed feature words compared after unpacking, with one bf16
    ulp of the value beyond that (the RNE of two f32 sums taken in another
    order can differ by one step).  Returns (max |diff|, the worst
    column's diff over its scale, values outside)."""
    if packed:
        got = torch.cat([got[:, :6], seg.unpack_bf16_pairs(got[:, 6:], Cg)],
                        dim=1)
        want = torch.cat([want[:, :6], seg.unpack_bf16_pairs(want[:, 6:],
                                                               Cg)], dim=1)
    d = (got - want).abs()
    scale = want.abs().amax(dim=0)
    tol = 1e-3 * scale[None].expand_as(d)
    if packed:
        mag = torch.maximum(got.abs(), want.abs())[:, 6:]
        ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(1e-30))) - 7)
        tol = torch.cat([tol[:, :6], tol[:, 6:] + ulp], dim=1)
    bad = int((d > tol).sum())
    worst = float((d.amax(dim=0) / scale.clamp_min(1e-30)).max())
    return float(d.max()), worst, bad


def load_workload(kind, device="cuda") -> Workload:
    """``kind`` "asset" (``asset_workload``) or "synthetic"
    (``synthetic_workload`` at make_workload's defaults); a ``Workload`` is
    returned as it is."""
    if isinstance(kind, Workload):
        return kind
    if kind == "asset":
        return asset_workload(device)
    if kind == "synthetic":
        return synthetic_workload(device=device)
    raise ValueError(f"workload must be 'asset' or 'synthetic', got {kind!r}")


# ------------------------------------------------------------- bounds ---
# Each probe's bound counts the work its own variant does on these inputs:
# bytes read once and written once, and the fp32 operations of the pairs
# its walk reaches (chip_smoke.py and the entry modules print both).

def pair_stats(w: Workload) -> dict:
    """The pair counts behind the P1 and P2 bounds on ``w``: K1's walk
    (``k1_pair_counts`` on K1's own n_contrib, and under "culled" its
    ``k1_culled_pairs``), the walk over every instance (``walk_counts``),
    and K2's walk on ``w.packed``: the pairs up to n_contrib (k2_tested),
    those it composites, and those ``no_alpha`` composites."""
    C = w.C
    nc2 = w.packed[:, C + 1]
    if w.packed_is_k1:
        k1 = w.pairs or k1_pair_counts(*w.k1_args, nc2)
        culled = w.culled or k1_culled_pairs(*w.k1_args, nc2)
        k2 = k1
    else:
        nc1 = comp.composite_forward(*w.k1_args)[:, C + 1]
        k1 = k1_pair_counts(*w.k1_args, nc1)
        culled = k1_culled_pairs(*w.k1_args, nc1)
        k2 = k1_pair_counts(*w.k1_args, nc2)
    s = dict(k1)
    s["culled"] = culled
    s.update(walk_counts(*w.k1_args))
    s["k2_tested"] = int(torch.minimum(
        torch.floor(nc2).long(), w.counts.long()[:, None]).sum())
    s["k2_composited"] = k2["composited"]
    s["no_alpha"] = no_alpha_pairs(w.table, w.gauss_id, w.starts, w.counts,
                                   nc2)
    return s


def k1_bytes(w: Workload) -> int:
    """K1's bytes: the table, the ids, the ranges read once, the packed
    output written once."""
    T = w.starts.shape[0]
    return (w.table.numel() * 4 + int(w.counts.sum()) * 4 + 2 * 4 * T
            + T * (w.C + 2) * comp.TILE_PIX * 4)


def k2_bytes(w: Workload) -> int:
    """K2's bytes: K1's inputs, the packed output and its cotangent read
    once, the [I, 6+Cg] rows written once."""
    T = w.starts.shape[0]
    return (w.table.numel() * 4 + int(w.counts.sum()) * 4 + 2 * 4 * T
            + 2 * w.packed.numel() * 4
            + w.gauss_id.shape[0] * (comp.ATTR_BASE + w.Cg) * 4)


def k1_ops(s: dict, C: int, test_ops=K1_TEST_OPS, comp_ops=None,
           quad=False, unpack=0) -> int:
    """K1's operation count on a walk after the cull, ``s`` of
    ``k1_culled_pairs``: ``test_ops`` per live pair (a pixel's pairs up to
    its stop that its warp's cull bit keeps), K1_STEP_OPS per composited or
    stopping pair, ``comp_ops`` (1 + 2C) per composited one, and the cull's
    operations; ``quad`` adds the coefficients and ``unpack`` (the packed
    forms' stored features) their unpacking per real instance a tile
    needs."""
    comp_ops = 1 + 2 * C if comp_ops is None else comp_ops
    per_instance = (CULL_INSTANCE_OPS + QUAD_COEF_OPS * bool(quad)
                    + UNPACK_OPS * unpack)
    return (test_ops * s["live"]
            + K1_STEP_OPS * (s["composited"] + s["stopping"])
            + comp_ops * s["composited"]
            + per_instance * s["staged"] + CULL_WARP_OPS * s["masks"]
            + CULL_EDGE_OPS * s["mask_edges"])


def fwd_ops(variant: str, C: int, s: dict) -> int:
    """P1's operations per variant.  Variants on K1's walk count K1's pairs
    after the cull (``k1_ops`` on ``s["culled"]``; quad_power's power takes
    10 operations for base's 11, and its coefficients; no_matmul's composite
    3 for 1 + 2C); the variants without K1's termination test
    every pair of every tile (17 each) and step each passing one (no_cond:
    3 + 1 + 2C, masked; no_scan 3 + 2C; stripped and no_exp 2 + 1 + 2C;
    alpha_only 1); no_exp's tested pair takes 16 (1 + power for the exp2
    and its argument) and its passing pairs are its own."""
    full = 1 + 2 * C
    walk = K1_TEST_OPS * s["all"]
    k1 = s["culled"]
    return {
        "base": k1_ops(k1, C),
        "trim_bookkeeping": k1_ops(k1, C),
        "no_minmax": k1_ops(k1, C),
        "no_matmul": k1_ops(k1, C, comp_ops=3),
        "quad_power": k1_ops(k1, C, test_ops=K1_TEST_OPS - 1, quad=True),
        "no_cond": walk + (K1_STEP_OPS + full) * s["passing"],
        "no_scan": walk + (K1_STEP_OPS + 2 * C) * s["passing"],
        "alpha_only": walk + s["passing"],
        "stripped": walk + (2 + full) * s["passing"],
        "no_exp": ((K1_TEST_OPS - 1) * s["all"]
                   + (2 + full) * s["passing_no_exp"]),
    }[variant]


def fwd_exps(variant: str, s: dict) -> int:
    """P1's exponentials: one per pair its walk tests (K1's after the cull,
    or every pair of the tile for the variants without K1's termination);
    no_exp takes none."""
    if variant == "no_exp":
        return 0
    if variant in ("no_cond", "no_scan", "alpha_only", "stripped"):
        return s["all"]
    return s["culled"]["live"]


def bwd_exps(variant: str, s: dict) -> int:
    """P2's exponentials: one per pair up to n_contrib; no_alpha takes
    none."""
    return 0 if variant == "no_alpha" else s["k2_tested"]


def bwd_ops(variant: str, C: int, Cg: int, s: dict) -> int:
    """P2's operations per variant: K2's count on its walk (18 per pair up
    to n_contrib, 24 + 2C + 2Cg per composited pair); ``exp`` drops the
    exp2 argument's multiply (17), ``no_alpha`` tests with 5 (dx, dy, the
    cap, the two tests) and composites its own pairs, ``no_moments`` drops
    five products and five sums, ``no_dfeat`` replaces 2Cg by one sum."""
    t, c = s["k2_tested"], s["k2_composited"]
    full = k2_pair_ops(C, Cg)
    return {
        "base": K2_TEST_OPS * t + full * c,
        "moments_basis": K2_TEST_OPS * t + full * c,
        "exp": (K2_TEST_OPS - 1) * t + full * c,
        "no_alpha": 5 * t + full * s["no_alpha"],
        "no_moments": K2_TEST_OPS * t + (full - 10) * c,
        "no_dfeat": K2_TEST_OPS * t + (full - 2 * Cg + 1) * c,
    }[variant]


def staged_instances(w: Workload, limits=None):
    """(staged, real): the instances a staging reads (tile t stages
    min(limits[t], counts[t])) and those of them that are not the pad
    sentinel."""
    P = w.table.shape[0]
    n = w.counts.long() if limits is None else torch.minimum(
        limits.long(), w.counts.long())
    g = w.gauss_id.long()
    real = torch.cat([torch.zeros(1, dtype=torch.long, device=g.device),
                      torch.cumsum(((g >= 0) & (g < P)).long(), 0)])
    st = w.starts.long()
    return int(n.sum()), int((real[st + n] - real[st]).sum())


def staged_bytes(w: Workload, limits=None) -> int:
    """Bytes K1's staging reads: each staged instance's id, and the row of
    each staged real instance."""
    staged, n_real = staged_instances(w, limits)
    return staged * 4 + n_real * w.table.shape[1] * 4


def load_bounds(w: Workload, limits, resident_pairs) -> dict:
    """(ms, by) of P3's tile variants: load_only and load_only_4tiles by
    their bytes (the staging's rows read once a tile, up to its CTAs'
    largest limit; the ranges and limits; the sums written);
    compute_resident by K1's operations on its own walk
    (``resident_pairs``: ``k1_culled_pairs`` of the resident list) against
    the first batch's bytes and K1's output."""
    T = w.starts.shape[0]
    npix = comp.TILE_PIX
    first = torch.clamp(w.counts, max=comp._KERNEL_BATCH).to(torch.int32)
    staged = staged_bytes(w, limits.amax(dim=1))
    ranges = (2 + limits.shape[1]) * 4 * T
    per = TILES_PER_CTA
    return {
        "load_only": bound_ms(staged + ranges + T * npix * 4, 0),
        "load_only_4tiles": bound_ms(
            staged + ranges + (T + per - 1) // per * npix * 4, 0),
        "compute_resident": bound_ms(
            staged_bytes(w, first) + 2 * 4 * T + T * (w.C + 2) * npix * 4,
            k1_ops(resident_pairs, w.C), nexp=resident_pairs["live"]),
    }


def expand_bound(S: int, I: int, n_extra: int = 0):
    """(ms, by, bytes, operations) of K3 (``n_extra`` 0) or K3x: each of the
    S sources read once (offset, meta, gid, ``n_extra`` floats), each of the
    I slots written once (tile, gid, the extras), and one decode a slot."""
    nbytes = (3 + n_extra) * 4 * S + (2 + n_extra) * 4 * I
    nops = K3_DECODE_OPS * I
    return (*bound_ms(nbytes, nops), nbytes, nops)


class K3Sources(NamedTuple):
    """Sources of K3 and K3x built by hand (``k3_sources``)."""
    offsets: torch.Tensor       # [S] int32, from 0, non-decreasing
    meta: torch.Tensor          # [S] int32 packed (base, rw >= 1, colstep)
    gid: torch.Tensor           # [S] int32
    extras: torch.Tensor        # [n_extra, S] float32
    rw_bits: int
    grid_x: int
    num_tiles: int

    def args(self, I: int):
        """K3's arguments at capacity I (``binning.expand``'s order)."""
        return (self.offsets, self.meta, self.gid, I, self.rw_bits,
                self.grid_x, self.num_tiles)


def k3_sources(I: int, n_empty: int, long_len: int, reach: float = 1.2,
               n_extra: int = 8, seed: int = 0, grid_x: int = 60,
               grid_y: int = 34, device="cpu") -> K3Sources:
    """The shapes of work K3's partition must get right, at capacity I,
    drawn from ``numpy.random.default_rng(seed)``: random sources of 0 to
    24 slots (a quarter of them empty) over 0.3 I slots, a run of
    ``n_empty`` empty sources (one tie group with the source after it, cut
    by every CTA boundary inside it), random sources over 0.2 I, one source
    of ``long_len`` slots (spanning CTAs that consume no source), then
    random sources until the slots reach ``reach`` * I (offsets past I, as
    under overflow).  Meta words are packed as the asset's tile grid packs
    them (``grid_x`` by ``grid_y`` tiles, align 128), gaussian ids below
    2^20 and extras N(0, 1): all exact in the JAX kernel's f32 carrier."""
    rng = np.random.default_rng(seed)

    def random_run(slots):
        n = slots // 8 + 32
        lens = rng.integers(1, 25, n)
        lens[rng.random(n) < 0.25] = 0
        return lens[:int(np.searchsorted(np.cumsum(lens), slots)) + 1]

    lens = [random_run(int(0.3 * I)), np.zeros(n_empty, np.int64),
            random_run(int(0.2 * I)), np.array([long_len])]
    done = int(sum(x.sum() for x in lens))
    lens.append(random_run(max(1, math.ceil(reach * I) - done)))
    lens = np.concatenate(lens).astype(np.int64)
    S = lens.shape[0]
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    num_tiles = grid_x * grid_y
    _, rw_bits, pack_meta = meta_layout(grid_x, num_tiles, 128)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    meta = pack_meta(t(rng.integers(0, num_tiles, S)),
                     t(rng.integers(1, grid_x + 1, S)),
                     t(rng.integers(0, 2, S)))
    return K3Sources(
        offsets=t(offsets.astype(np.int32)), meta=meta.contiguous(),
        gid=t(rng.integers(0, 1 << 20, S).astype(np.int32)),
        extras=t(rng.standard_normal((n_extra, S)).astype(np.float32)),
        rw_bits=rw_bits, grid_x=grid_x, num_tiles=num_tiles)


# The hand-built sources at full scale (chip_smoke.py and k2_trees.py): the
# asset's instance capacity, a run of 200,000 empty sources, a source of
# 300,000 slots, offsets reaching 1.2 I.
K3_FULL_I = 2_359_296


def k3_full_sources(device="cuda") -> K3Sources:
    return k3_sources(K3_FULL_I, 200_000, 300_000, device=device)


def gather_bound(variant: str, I: int, R: int, unique_rows: int):
    """(ms, by) of row_gather (ids, the distinct rows read, the rows
    written) and block_copy ([I, R] read and written)."""
    if variant == "row_gather":
        return bound_ms(I * 4 + unique_rows * R * 4 + I * R * 4, 0)
    return bound_ms(2 * I * R * 4, 0)


# mul, mul, mul, add, the exp argument (a negation, or in float32 the product
# by -log2 e), exp, mul, mul, add, add, mul
DTYPE_OPS = 11


def dtype_bound(n: int, itemsize: int, n_programs: int, n_iters: int, bf16):
    """(ms, by) of P4: 11 operations per element and round in every
    program, over the fp32 rate or the bf16 one, and one exponential per
    element and round in either form (h2exp of a bf16 pair is two
    MUFU.EX2); x read and out written once."""
    rounds = n * n_programs * n_iters
    return bound_ms(2 * n * itemsize, DTYPE_OPS * rounds,
                    BF16_OPS_PER_S if bf16 else FP32_OPS_PER_S, nexp=rounds)


# fp32 operations of K7 and K8 (csrc/ssim.cu) per pixel and channel, a
# multiply and an add counted apart: a window pass of one plane is 11
# products and 10 sums (21); the five planes take x^2, y^2 and xy (3) and
# two passes each (210); a pixel's SSIM takes the three moments' products,
# the three variances, N1, N2, D1, D2 (two each), their two products and the
# quotient (17), and the forward's mean one sum (1).  K8 recomputes the
# planes and S, forms A (11), B (2) and Cxy (2), runs two passes over those
# three planes (126) and combines them with x, y and the scale (6).
SSIM_PASS_OPS = 21
SSIM_FWD_OPS = 3 + 2 * 5 * SSIM_PASS_OPS + 17 + 1
SSIM_BWD_OPS = 3 + 2 * 5 * SSIM_PASS_OPS + 17 + 15 + 2 * 3 * SSIM_PASS_OPS + 6


def ssim_bound(C: int, H: int, W: int, backward: bool = False):
    """(ms, by, bytes, operations) of K7 (the mean of SSIM over [C, H, W])
    or, with ``backward``, of K8 (the gradient with respect to img1): the
    two images read once and the mean (4 bytes) or the gradient plane and
    the upstream gradient's 4 bytes; nothing of a design's intermediates."""
    n = C * H * W
    if backward:
        nbytes, nops = 3 * 4 * n + 4, SSIM_BWD_OPS * n
    else:
        nbytes, nops = 2 * 4 * n + 4, SSIM_FWD_OPS * n
    return (*bound_ms(nbytes, nops), nbytes, nops)
