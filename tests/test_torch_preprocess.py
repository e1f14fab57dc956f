"""Port preprocess vs the JAX package on the same numpy inputs: the
integer outputs (radii, rects, tiles_touched, visible) exactly, the float
outputs at rtol/atol 1e-5."""
import numpy as np
import pytest

from torch_helpers import make_camera, make_gaussians_np, preprocess_both

INT_FIELDS = ("radii", "rect_min", "rect_max", "tiles_touched", "visible")
FLOAT_FIELDS = ("depths", "means2d", "conic", "rgb", "opacity")


def _assert_match(pj, pt):
    for f in INT_FIELDS:
        a, b = np.asarray(getattr(pj, f)), getattr(pt, f).numpy()
        bad = np.nonzero((a != b).reshape(a.shape[0], -1).any(axis=1))[0]
        assert bad.size == 0, f"{f} differs for gaussians {bad.tolist()}"
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(pt, f).numpy(),
                                   np.asarray(getattr(pj, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)


@pytest.mark.parametrize("seed,W,H,spread", [(0, 64, 64, 1.2),
                                             (1, 96, 48, 2.5),
                                             (2, 48, 80, 0.6)])
def test_preprocess_matches_jax(seed, W, H, spread):
    rng = np.random.default_rng(seed)
    g = make_gaussians_np(rng, n=400, spread=spread)
    g["means3d"][:20, 2] += 5.0        # some behind the camera / near plane
    pj, pt = preprocess_both(g, make_camera(W, H), W, H)
    assert int(pt.visible.sum()) > 100
    _assert_match(pj, pt)


def test_preprocess_precomputed_inputs_match_jax():
    rng = np.random.default_rng(3)
    g = make_gaussians_np(rng, n=200)
    colors = rng.uniform(size=(200, 3)).astype(np.float32)
    cov = rng.standard_normal((200, 6)).astype(np.float32) * 0.01
    cov[:, [0, 3, 5]] = np.abs(cov[:, [0, 3, 5]]) + 0.02
    pj, pt = preprocess_both(g, make_camera(64, 64), 64, 64, sh_degree=2,
                             colors_precomp=colors, cov3d_precomp=cov,
                             scale_modifier=0.7)
    _assert_match(pj, pt)


def test_preprocess_crop_matches_jax():
    """The crop arguments: a 64x32 slice at pixel offset (0, 32) of a
    64x96 camera, in full-image pixel space."""
    rng = np.random.default_rng(4)
    g = make_gaussians_np(rng, n=300)
    pj, pt = preprocess_both(g, make_camera(64, 96), 64, 32, full_width=64,
                             full_height=96, pixel_offset=(0, 32))
    _assert_match(pj, pt)
