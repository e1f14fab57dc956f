"""The kernel probes of ``gsplat_tpu_torch.tools`` on the CPU: each probe's
plain PyTorch version (what its CUDA kernel is held to on the card)
against the JAX tool it ports, or against the port's K1/K2 plain versions,
at small sizes.  The tools are scripts, not a package: ``tools/`` goes on
``sys.path`` and their Pallas kernels run in interpret mode."""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gsplat_tpu.ops import composite_pallas as cp
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops import composite_cuda as tcomp
from gsplat_tpu_torch.ops import preprocess as tpre
from gsplat_tpu_torch.tools import (bench_bwd_attrib, bench_dma_overhead,
                                    bench_fwd_attrib, bench_inkernel_gather,
                                    bench_kernels, bench_vpu_dtype, probes,
                                    timing)
from gsplat_tpu_torch.tools import workload as wl

from torch_helpers import GAUSS_KEYS, cam_np, make_camera, make_gaussians_np

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")


def _tool(name):
    if TOOLS not in sys.path:
        sys.path.insert(0, TOOLS)
    return __import__(name)


def _dense_workload():
    """K1's and K2's inputs for a dense cloud at 64x64 (4 tiles of about
    490 instances; all but a few pixels terminate, and two tiles end inside
    their first batch), C = 7 as the training path, a seeded cotangent."""
    rng = np.random.default_rng(0)
    W = H = 64
    n = 500
    g = make_gaussians_np(rng, n=n, spread=0.8)
    g["opacities"] = rng.uniform(0.5, 0.99, n).astype(np.float32)
    g["scales"] *= 8
    c = cam_np(make_camera(W, H))
    ta = [torch.from_numpy(np.array(g[k])) for k in GAUSS_KEYS] + [
        torch.from_numpy(np.array(c[k]))
        for k in ("viewmatrix", "projmatrix", "campos")]
    pre = tpre.preprocess(*ta[:5], 3, *ta[5:], c["tan_fovx"], c["tan_fovy"],
                          W, H)
    gx = (W + tpre.TILE_X - 1) // tpre.TILE_X
    gy = (H + tpre.TILE_Y - 1) // tpre.TILE_Y
    bins = tbin.bin_gaussians(pre, gx, gy, 1 << 13)
    assert not bool(bins.overflow)
    feats = torch.from_numpy(rng.uniform(0.1, 1.0, (n, 7)).astype(
        np.float32))
    table = torch.cat([pre.means2d, pre.conic, pre.opacity[:, None], feats],
                      dim=1).contiguous()
    starts, counts = tcomp.tile_ranges(bins)
    gid = bins.gauss_id.contiguous()
    packed = tcomp.composite_forward_plain(table, gid, starts, counts, gx)
    d_packed = torch.from_numpy(rng.standard_normal(
        tuple(packed.shape)).astype(np.float32))
    w = wl.Workload(table, gid, starts, counts, gx, packed, d_packed, Cg=6,
                    name="dense", packed_is_k1=True)
    w.pairs = wl.k1_pair_counts(*w.k1_args, packed[:, w.C + 1])
    return w


def test_quad_power_alpha_matches_jax_mxu_power():
    """(a) the quad power form's alpha and mask (``pair_terms`` with the
    tile basis, the path of K1's and K2's plain versions) against the
    Pallas kernel's own ``_chunk_alpha(mxu_power=True)`` on a seeded
    128-instance chunk of a 32x32 tile: masks equal, alpha within 2e-5.  JAX's matmul and the
    port's six products sum the same terms, some of them hundreds, in
    another order: on this chunk they differ by 6.7e-6, and JAX's own MXU
    form differs from its VPU form by 8.5e-6."""
    rng = np.random.default_rng(7)
    K, grid_x, t = 128, 5, 7                  # tile 7 of a 5-wide grid
    ox = (t % grid_x) * cp.TILE_X
    oy = (t // grid_x) * cp.TILE_Y
    buf = np.zeros((6, K), np.float32)
    buf[0] = ox + rng.uniform(-20, cp.TILE_X + 20, K)
    buf[1] = oy + rng.uniform(-20, cp.TILE_Y + 20, K)
    a = rng.uniform(0.002, 0.2, K)
    c = rng.uniform(0.002, 0.2, K)
    buf[2], buf[4] = a, c
    buf[3] = rng.uniform(-0.9, 0.9, K) * np.sqrt(a * c)
    buf[5] = rng.uniform(0.0, 1.0, K)
    valid = np.arange(K) < 120
    px, py, origin = cp._pixel_coords(jnp.int32(t), grid_x)
    a_j, m_j, _ = cp._chunk_alpha(jnp.asarray(buf), px, py,
                                  jnp.asarray(valid)[:, None],
                                  mxu_power=True, origin=origin)
    tiles = torch.tensor([t])
    px_t, py_t = tcomp.pixel_coords(tiles, grid_x)
    _, _, power, raw = tcomp.pair_terms(
        torch.from_numpy(buf.T.copy())[None], px_t, py_t,
        quad=tcomp.tile_basis(tiles, grid_x))
    alpha = torch.clamp(raw, max=tcomp.ALPHA_MAX)
    mask = (torch.from_numpy(valid)[None, :, None]
            & (power <= tcomp.QUAD_POWER_CUT) & (alpha >= tcomp.ALPHA_MIN))
    a_t = torch.where(mask, alpha, 0.0)[0].numpy()
    np.testing.assert_array_equal(mask[0].numpy(), np.asarray(m_j))
    assert 1000 < int(mask.sum()) < K * tcomp.TILE_PIX
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=0, atol=2e-5)


def test_probe_variants_against_k1_k2_plain_versions():
    """(b), and (d)'s half on K1 and K2: on a dense 64x64 workload, P1's and
    P2's base plain versions equal ``composite_forward_plain`` and
    ``composite_backward_plain``, as do the P1 variants that only remove
    cost (no_cond, trim_bookkeeping); moments_basis and exp are within K2's
    tolerance of K2's plain version (1e-3 of each column's largest value);
    each other knockout writes what its kernel's comment says.  Then the six
    entry modules' plumbing on the CPU with the timer stubbed, on a tiny
    synthetic workload."""
    w = _dense_workload()
    C = w.C
    assert 4000 < int(w.pairs["stopping"]) < 4 * tcomp.TILE_PIX
    assert (w.pairs["limits"] < w.counts[:, None]).any()
    k1 = w.packed
    out = {v: probes.probe_forward(v, *w.k1_args)
           for v in probes.FWD_VARIANTS}
    for v in ("base", "no_cond", "trim_bookkeeping"):
        assert torch.equal(out[v], k1), v
    np.testing.assert_array_equal(out["no_minmax"][:, :C + 1], k1[:, :C + 1])
    assert float(out["no_minmax"][:, C + 1].abs().max()) == 0.0
    ones = tcomp.composite_forward_plain(
        torch.cat([w.table[:, :6], torch.ones_like(w.table[:, :1])], 1),
        *w.k1_args[1:])
    np.testing.assert_allclose(out["no_matmul"][:, 0], ones[:, 0], atol=1e-6)
    assert float(out["no_matmul"][:, 1:C].abs().max()) == 0.0
    for v in ("no_scan", "alpha_only"):         # T is never updated
        assert float((out[v][:, C] - 1.0).abs().max()) == 0.0, v
    for v in ("stripped", "no_exp", "alpha_only"):
        assert float(out[v][:, C + 1].abs().max()) == 0.0, v
    # no termination: stripped walks past where K1 stopped
    assert bool((out["stripped"][:, C] < k1[:, C]).any())
    np.testing.assert_allclose(out["quad_power"][:, :C + 1], k1[:, :C + 1],
                               atol=3e-4)

    k2 = tcomp.composite_backward_plain(*w.k2_args)
    assert torch.equal(probes.probe_backward("base", *w.k2_args), k2)
    scale = k2.abs().amax(dim=0)
    assert bool((scale > 0).all())
    for v in ("moments_basis", "exp"):
        d = probes.probe_backward(v, *w.k2_args)
        worst = float(((d - k2).abs().amax(dim=0) / scale).max())
        assert worst <= 1e-3, (v, worst)
    d = probes.probe_backward("no_moments", *w.k2_args)
    np.testing.assert_array_equal(d[:, 5:], k2[:, 5:])
    for j in range(5):
        assert torch.equal(d[:, j], d[:, 0])
    d = probes.probe_backward("no_dfeat", *w.k2_args)
    np.testing.assert_array_equal(d[:, :6], k2[:, :6])
    assert float(d[:, 7:].abs().max()) == 0.0

    # P3's tile variants: compute_resident is K1 on the resident list, and
    # the 4-tile walk carries load_only's per-tile sums in order
    res = probes.probe_load("compute_resident", *w.k1_args)
    assert torch.equal(res, tcomp.composite_forward_plain(
        w.table, wl.resident_ids(w.gauss_id, w.starts, w.counts),
        *w.k1_args[2:]))
    lim = w.pairs["limits"]
    one = probes.probe_load("load_only", *w.k1_args, limits=lim)
    four = probes.probe_load("load_only_4tiles", *w.k1_args, limits=lim)
    assert one.shape == (4, tcomp.TILE_PIX) and four.shape == (1,
                                                                tcomp.TILE_PIX)
    np.testing.assert_allclose(four[0], one.sum(0), rtol=1e-5, atol=1e-4)
    full = probes.probe_load("load_only", *w.k1_args)
    assert not torch.equal(full, one)           # the limits cut batches

    # the entry modules on the CPU, timing stubbed, on a tiny synthetic
    # workload: every variant runs through its wrapper
    stub = dict(cuda_device=lambda device="cuda": torch.device("cpu"),
                card_line=lambda: "cpu", median_ms=lambda fn, iters=10,
                warmup=2: (fn(), 1.0)[1])
    saved = {k: getattr(timing, k) for k in stub}
    w = wl.synthetic_workload(grid_x=2, grid_y=1, mean_count=100, C=7,
                              device="cpu")
    w.Cg = 6
    try:
        for k, f in stub.items():
            setattr(timing, k, f)
        stats = wl.pair_stats(w)
        rows = bench_fwd_attrib.main("cpu", w, stats)
        rows += bench_bwd_attrib.main("cpu", w, stats)
        rows += bench_kernels.main("cpu", w, stats)[1]
        rows += bench_dma_overhead.main("cpu", w, stats)
        rows += bench_vpu_dtype.main("cpu")
        for _, r in bench_inkernel_gather.main("cpu", w):
            rows += r
    finally:
        for k, f in saved.items():
            setattr(timing, k, f)
    assert len(rows) == 7 + 6 + 2 + 4 + 2 + 6
    assert all(r["bound_ms"] > 0 and r["ms"] == 1.0 for r in rows)


def test_gather_plain_matches_jax_tool():
    """(c) row_gather and block_copy's plain versions against the tool's
    own Pallas kernels in interpret mode, at I = 1,024 and R = 128: equal."""
    tool = _tool("bench_inkernel_gather")
    rng = np.random.default_rng(0)
    P, I = 3000, 1024
    table = rng.standard_normal((P, tool.R)).astype(np.float32)
    ids = rng.integers(0, P, I).astype(np.int32)
    got = probes.probe_gather("row_gather", torch.from_numpy(table),
                              torch.from_numpy(ids))
    want = tool.rowdma_gather(jnp.asarray(table), jnp.asarray(ids),
                              interpret=True)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).reshape(I, tool.R))
    chunks = got.numpy().reshape(I // tool.CHUNK, tool.CHUNK, tool.R)
    copied = probes.probe_gather("block_copy", got)
    want = tool.blockdma_copy(jnp.asarray(chunks), interpret=True)
    np.testing.assert_array_equal(copied.numpy(),
                                  np.asarray(want).reshape(I, tool.R))


def test_dtype_mix_and_synthetic_workload_match_jax_tools():
    """(d) P4's plain op mix against ``bench_vpu_dtype.kernel`` through
    ``pl.pallas_call(interpret=True)`` on a seeded [16, 128] block, 8
    rounds: float32 within 1e-6 relative; bfloat16 within 2^-6 relative
    (JAX's CPU backend may keep intermediates in float32 where the port
    rounds every operation to bf16).  ``synthetic_workload`` against
    ``bench_dma_overhead.make_workload``'s arrays from the same seed."""
    tool = _tool("bench_vpu_dtype")
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 1.0, (16, 128)).astype(np.float32)
    for dt, tdt, rtol in ((jnp.float32, torch.float32, 1e-6),
                          (jnp.bfloat16, torch.bfloat16, 2.0 ** -6)):
        xj = jnp.asarray(x).astype(dt)
        want = pl.pallas_call(
            lambda x_ref, o_ref: tool.kernel(8, x_ref, o_ref),
            out_shape=jax.ShapeDtypeStruct(x.shape, dt), interpret=True)(xj)
        want = np.asarray(want.astype(jnp.float32))
        xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
        got = probes.probe_dtype(xt, 4, 8).float().numpy()
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=str(dt))

    tool = _tool("bench_dma_overhead")
    attr, ranges, T, nch, R = tool.make_workload(grid_x=4, grid_y=3,
                                                 mean_count=200)
    w = wl.synthetic_workload(grid_x=4, grid_y=3, mean_count=200,
                              device="cpu")
    attr, ranges = np.asarray(attr), np.asarray(ranges)
    assert T == w.starts.shape[0] == w.counts.shape[0] == 12
    np.testing.assert_array_equal(w.counts.numpy(), ranges[:T, 1])
    np.testing.assert_array_equal(w.starts.numpy(), ranges[:T, 0] * 128)
    rows = attr.transpose(0, 2, 1).reshape(nch * 128, R)
    np.testing.assert_array_equal(w.table.numpy(), rows[:, :w.table.shape[1]])
    for s, n in zip(w.starts.tolist(), w.counts.tolist()):
        assert w.gauss_id[s:s + n].tolist() == list(range(s, s + n))
    assert w.table.shape == (nch * 128, 11) and w.C == 5


def test_bounds_take_the_largest_of_three_terms():
    """``bound_ms`` is the largest of bytes over the HBM rate, operations
    over the arithmetic rate and exponentials over the SFU rate, and names
    it; P4's bound at the tool's shape is its 1,073,741,824 exponentials,
    0.2568 ms, in both forms."""
    assert wl.bound_ms(3.35e9, 0) == (pytest.approx(1.0), "bytes")
    assert wl.bound_ms(1e9, 67e9) == (pytest.approx(1.0), "operations")
    assert wl.bound_ms(1e9, 1e9, nexp=wl.SFU_RESULTS_PER_S * 2e-3) == (
        pytest.approx(2.0), "exponentials")
    assert wl.bound_ms(0, 133.8e9, wl.BF16_OPS_PER_S, nexp=1e6) == (
        pytest.approx(1.0), "operations")
    n = bench_vpu_dtype.SHAPE[0] * bench_vpu_dtype.SHAPE[1]
    assert n * bench_vpu_dtype.N_PROGRAMS * bench_vpu_dtype.N_ITERS == \
        1_073_741_824
    for itemsize, bf16 in ((4, False), (2, True)):
        ms, by = wl.dtype_bound(n, itemsize, bench_vpu_dtype.N_PROGRAMS,
                                bench_vpu_dtype.N_ITERS, bf16)
        assert by == "exponentials" and round(ms, 4) == 0.2568
