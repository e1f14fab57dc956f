"""Exact-cull binning in the port against the JAX package on the CPU: the
extras form of K3's plain version against the JAX Pallas kernel (interpret
mode) on real stage-A sources, ``bin_gaussians(cull="exact")`` field by
field (with and without a row-capacity overflow), and exact-cull
``rasterize`` against the JAX package's."""
import functools

import numpy as np
import pytest
import torch

from gsplat_tpu.ops import binning as jbin
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

from torch_helpers import (ATOL, jax_pre_to_torch, make_camera,
                           make_gaussians_np, preprocess_both,
                           rasterize_both)

W, H = 128, 96
CULL = dict(cull="exact", max_rows=1 << 12)


@functools.lru_cache(maxsize=None)
def _pre(seed, n):
    rng = np.random.default_rng(seed)
    g = make_gaussians_np(rng, n=n, spread=1.5)
    pj, _ = preprocess_both(g, make_camera(W, H), W, H)
    gx, gy = (W + TILE_X - 1) // TILE_X, (H + TILE_Y - 1) // TILE_Y
    return pj, jax_pre_to_torch(pj), gx, gy


def test_expand_extras_plain_matches_jax_kernel():
    """The extras form of K3's plain version against the JAX Pallas kernel
    on exact cull's real stage-A sources: rows, gaussian ids and all 8 f32
    extras bit-equal."""
    _, pt, gx, gy = _pre(5, 1500)
    rs = tbin.row_sources(pt, gx, gy, 128)
    IR = 4096                                # stage A's shapes below
    assert 0 < int(rs.rows_total) < IR       # the tail fills the rest
    rw_bits = tbin.meta_layout(gx, gx * gy, 128)[1]
    ty, gid, ext = tbin.expand_plain(rs.offsets, rs.meta, rs.gid, IR,
                                     rw_bits, gx, gy, extras=rs.extras)
    jt, jg, je = jbin._expand_pallas(
        rs.offsets.numpy(), rs.meta.numpy(), rs.gid.numpy(), IR, rw_bits, gx,
        gy, interpret=True, extras=tuple(e for e in rs.extras.numpy()))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jg))
    assert ext.shape == (8, IR) and ext.dtype == torch.float32
    np.testing.assert_array_equal(ext.numpy(), np.asarray(je))
    # the wrapper takes the plain version for CPU tensors
    got = tbin.expand(rs.offsets, rs.meta, rs.gid, IR, rw_bits, gx, gy,
                      extras=rs.extras)
    for a, b in zip(got, (ty, gid, ext)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("seed,n,I,max_rows", [
    (5, 1500, 8192, 0),          # no overflow; row capacity I // 2
    (6, 1500, 8192, 1024),       # stage A's rows overflow their capacity
])
def test_exact_cull_binning_matches_jax(seed, n, I, max_rows):
    pj, pt, gx, gy = _pre(seed, n)
    jb = jbin.bin_gaussians(pj, gx, gy, I, align=128, cull="exact",
                            max_rows=max_rows)
    tb = tbin.bin_gaussians(pt, gx, gy, I, align=128, cull="exact",
                            max_rows=max_rows)
    for f in jb._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    full = tbin.bin_gaussians(pt, gx, gy, I, align=128)
    rows = int(tbin.row_sources(pt, gx, gy, 128).rows_total)
    # exact fullness (padded demand == capacity) is avoided: ROADMAP Queue 3
    assert int(tb.num_padded) != I
    if max_rows:
        assert rows > max_rows and bool(tb.overflow)
    else:
        assert not bool(tb.overflow)
        assert 0 < int(tb.num_rendered) < int(full.num_rendered)


def test_exact_cull_rasterize_matches_jax():
    """Exact-cull ``rasterize`` against the JAX package's (Pallas path,
    interpret mode): the same instance counts and radii, images within the
    JAX tests' forward tolerances."""
    rng = np.random.default_rng(75)
    g = make_gaussians_np(rng, n=400)
    bg = np.array([0.15, 0.3, 0.1], np.float32)
    jo, to = rasterize_both(g, make_camera(96, 64), 96, 64, bg, **CULL)
    for k in ("num_rendered", "num_padded", "overflow"):
        assert int(to[k]) == int(jo[k]), k
    assert not bool(to["overflow"]) and int(to["num_rendered"]) > 300
    np.testing.assert_array_equal(to["radii"], jo["radii"])
    for k, tol in (("render", "render"), ("alpha", "alpha"),
                   ("depth", "depth"), ("T_final", "T_final")):
        np.testing.assert_allclose(to[k], jo[k], atol=ATOL[tol], rtol=0,
                                   err_msg=k)
