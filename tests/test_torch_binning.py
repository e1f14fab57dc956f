"""Port binning vs the JAX package: the same PreprocessOut goes to both, and
every BinningOut field must be bit-equal to the JAX expansion kernel K3
(Pallas, interpret mode on the CPU) and to the JAX XLA forward fill."""
import functools

import numpy as np
import pytest
import torch

from gsplat_tpu.ops import binning as jbin
from gsplat_tpu_torch.ops import binning as tbin
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y

from torch_helpers import (jax_pre_to_torch, make_camera, make_gaussians_np,
                           preprocess_both)

W, H = 128, 96


@functools.lru_cache(maxsize=None)
def _pre(seed, n=600):
    rng = np.random.default_rng(seed)
    g = make_gaussians_np(rng, n=n, spread=1.5)
    pj, _ = preprocess_both(g, make_camera(W, H), W, H)
    gx, gy = (W + TILE_X - 1) // TILE_X, (H + TILE_Y - 1) // TILE_Y
    return pj, jax_pre_to_torch(pj), gx, gy


def _assert_bins_equal(jb, tb):
    for f in jb._fields:
        np.testing.assert_array_equal(getattr(tb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def test_tile_histogram_matches_jax():
    pj, pt, gx, gy = _pre(0)
    np.testing.assert_array_equal(tbin._tile_histogram(pt, gx, gy).numpy(),
                                  np.asarray(jbin._tile_histogram(pj, gx, gy)))


@pytest.mark.parametrize("align,jax_impl", [(128, "pallas"), (128, "xla"),
                                            (1, "xla"), (1, "pallas")])
def test_binning_matches_jax(align, jax_impl):
    pj, pt, gx, gy = _pre(1)
    I = 1 << 14
    jb = jbin.bin_gaussians(pj, gx, gy, I, align=align, expand_impl=jax_impl)
    tb = tbin.bin_gaussians(pt, gx, gy, I, align=align)
    assert not bool(tb.overflow) and int(tb.num_rendered) > 500
    _assert_bins_equal(jb, tb)


def test_binning_overflow_matches_jax_kernel():
    """Under overflow the per-slot owner rule still defines every slot in
    [0, I): the port must equal the JAX kernel and stay in bounds."""
    pj, pt, gx, gy = _pre(2)
    I = 1024
    jb = jbin.bin_gaussians(pj, gx, gy, I, align=128, expand_impl="pallas")
    tb = tbin.bin_gaussians(pt, gx, gy, I, align=128)
    assert bool(tb.overflow) and int(tb.num_padded) > I
    _assert_bins_equal(jb, tb)
    P = pt.depths.shape[0]
    assert int(tb.gauss_id.max()) <= P and int(tb.tile_id.max()) <= gx * gy


def test_expand_plain_matches_jax_kernel_on_sources():
    """K3's plain version against the JAX Pallas kernel on the packed
    sources alone, before the tile sort."""
    _, pt, gx, gy = _pre(3)
    I = 1 << 13
    src = tbin.expansion_sources(pt, gx, gy, 128)
    tile, gid = tbin.expand_plain(src.offsets, src.meta, src.gid, I,
                                  src.rw_bits, gx, gx * gy)
    jt, jg = jbin._expand_pallas(src.offsets.numpy(), src.meta.numpy(),
                                 src.gid.numpy(), I, src.rw_bits, gx,
                                 gx * gy, interpret=True)
    np.testing.assert_array_equal(tile.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(gid.numpy(), np.asarray(jg))
    assert tile.dtype == gid.dtype == torch.int32


def test_unported_cull_raises():
    """A cull mode the port does not have raises, and exact cull refuses a
    capacity the JAX kernel's 1024-slot programs cannot tile (JAX asserts
    there; the port raises ValueError).  Exact cull itself is held against
    the JAX package in ``tests/test_torch_cull.py``."""
    _, pt, gx, gy = _pre(0)
    with pytest.raises(ValueError, match="cull"):
        tbin.bin_gaussians(pt, gx, gy, 1 << 12, cull="approx")
    with pytest.raises(ValueError, match="multiple of 1024"):
        tbin.bin_gaussians(pt, gx, gy, 1152, cull="exact")
    assert tbin.row_capacity(1 << 14) == 8192
    assert tbin.row_capacity(1 << 14, 1000) == 1024
    assert tbin.row_capacity(1024) == 1024
