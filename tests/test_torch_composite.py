"""Port compositor (K1's plain version on the CPU) vs the JAX Pallas path
(interpret mode) and the per-pixel oracle, at the JAX tests' tolerances."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsplat_tpu.ops.composite_ref import composite_reference as jref
from gsplat_tpu_torch.ops import composite_cuda as tcomp
from gsplat_tpu_torch.ops.composite_ref import composite_reference as tref

from torch_helpers import (assert_images_close, make_camera,
                           make_gaussians_np, preprocess_both,
                           rasterize_both)

BG = np.array([0.3, 0.2, 0.1], np.float32)


@pytest.mark.parametrize("num_class", [0, 3])
def test_composite_matches_jax_pallas_and_oracle(num_class):
    rng = np.random.default_rng(10 + num_class)
    W, H = 64, 64
    g = make_gaussians_np(rng, n=250, num_class=num_class)
    cam = make_camera(W, H)
    jo, to = rasterize_both(g, cam, W, H, BG, num_class=num_class)
    keys = ["render", "depth", "alpha", "T_final"] + (
        ["segment"] if num_class else [])
    assert_images_close(to, jo, keys)
    np.testing.assert_array_equal(to["radii"], jo["radii"])
    assert int(to["num_rendered"]) == int(jo["num_rendered"]) > 200

    # both oracles: the port's against the JAX one, and the port's
    # compositor against the JAX oracle
    pj, pt = preprocess_both(g, cam, W, H)
    seg = g.get("segments")
    ref_j = jref(pj, W, H, BG, segments=seg)
    ref_t = tref(pt, W, H, torch.from_numpy(BG),
                 segments=None if seg is None else torch.from_numpy(seg))
    for k in keys:
        np.testing.assert_allclose(ref_t[k].numpy(), np.asarray(ref_j[k]),
                                   atol=1e-5, err_msg=k)
    assert_images_close(to, {k: np.asarray(v) for k, v in ref_j.items()},
                        keys)


def test_composite_multichunk_with_termination():
    """One 32x32 image over >1024 instances per tile: the plain version
    walks many 128-instance chunks with carries across them, and an opaque
    front layer makes pixels terminate part-way."""
    rng = np.random.default_rng(30)
    n = 1300
    g = make_gaussians_np(rng, n=n, spread=0.6)
    g["scales"] = np.full((n, 3), 0.3, np.float32)
    op = np.full(n, 0.03, np.float32)
    op[:120] = 0.9
    g["opacities"] = op
    jo, to = rasterize_both(g, make_camera(32, 32), 32, 32, BG,
                            max_instances=1 << 15)
    assert int(to["num_rendered"]) > 1024
    assert float(to["T_final"].min()) < 1e-3        # termination reached
    assert_images_close(to, jo, ["render", "depth", "alpha", "T_final"])


def test_render_only_matches_jax():
    rng = np.random.default_rng(40)
    g = make_gaussians_np(rng, n=250)
    jo, to = rasterize_both(g, make_camera(64, 48), 64, 48, BG,
                            render_only=True)
    assert "depth" not in to
    assert_images_close(to, jo, ["render", "alpha", "T_final"])


def test_overflow_clamp_keeps_reads_in_bounds():
    """A capacity far below the demand: the per-tile ranges are clamped,
    the frame is finite and the flag is set (JAX sets it too)."""
    rng = np.random.default_rng(50)
    g = make_gaussians_np(rng, n=300)
    jo, to = rasterize_both(g, make_camera(64, 64), 64, 64, BG,
                            max_instances=256)
    assert bool(to["overflow"]) and bool(jo["overflow"])
    for k in ("render", "depth", "alpha"):
        assert np.isfinite(to[k]).all(), k


def test_tile_ranges_clamp():
    from gsplat_tpu_torch.ops.binning import BinningOut
    i32 = dict(dtype=torch.int32)
    bins = BinningOut(
        gauss_id=torch.zeros(256, **i32), tile_id=torch.zeros(256, **i32),
        tile_start=torch.tensor([0, 128, 256, 384], **i32),
        tile_count=torch.tensor([100, 200, 5, 0], **i32),
        num_rendered=torch.tensor(305, **i32),
        num_padded=torch.tensor(512, **i32), overflow=torch.tensor(True))
    starts, counts = tcomp.tile_ranges(bins)
    assert starts.tolist() == [0, 128, 256, 256]
    assert counts.tolist() == [100, 128, 0, 0]


def test_tile16_matches_jax_in_subprocess():
    """Both packages snapshot GSPLAT_TILE_X/Y at import, so the 16x16 tile
    (the CUDA reference's own) runs in a fresh interpreter."""
    here = os.path.dirname(os.path.abspath(__file__))
    path = [os.path.dirname(here), here, os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, GSPLAT_TILE_X="16", GSPLAT_TILE_Y="16",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(path))
    subprocess.run([sys.executable, os.path.abspath(__file__)], check=True,
                   env=env, cwd=here, timeout=300)


def _tile16_main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    from gsplat_tpu.ops import preprocess as jpre
    from gsplat_tpu_torch.ops import preprocess as tpre
    assert jpre.TILE_X == tpre.TILE_X == 16 and tcomp.TILE_PIX == 256
    rng = np.random.default_rng(60)
    g = make_gaussians_np(rng, n=250, num_class=2)
    jo, to = rasterize_both(g, make_camera(64, 48), 64, 48, BG, num_class=2)
    assert_images_close(to, jo, ["render", "depth", "alpha", "segment",
                                 "T_final"])
    assert int(to["num_rendered"]) == int(jo["num_rendered"])


if __name__ == "__main__":
    _tile16_main()
    print("tile 16x16 parity ok")
