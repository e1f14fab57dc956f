"""The whole slice: port ``renderer.render`` against
``gsplat_tpu.renderer.render(..., backend="pallas")`` on weights carried
over by ``params_from_numpy``, plus the empty-model and overflow probes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import renderer as jrenderer
from gsplat_tpu.models.gaussians import GaussianModel as JModel
from gsplat_tpu.models.gaussians import GaussianParams as JParams
from gsplat_tpu_torch import renderer as trenderer
from gsplat_tpu_torch.models.gaussians import GaussianModel, params_from_numpy
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

from torch_helpers import ATOL, make_camera


def _jax_model(rng, n=260, capacity=320, num_class=2):
    """A JAX model with n random live gaussians in a capacity of dead
    slots."""
    m = JModel(3, num_class=num_class, capacity=capacity)
    p = {k: np.array(v) for k, v in m.params._asdict().items()}
    p["xyz"][:n] = rng.standard_normal((n, 3)) * 1.2
    p["features_dc"][:n] = rng.standard_normal((n, 1, 3)) * 0.8
    p["features_rest"][:n] = rng.standard_normal((n, 15, 3)) * 0.2
    p["scaling"][:n] = rng.standard_normal((n, 3)) * 0.5 - 2.5
    p["rotation"][:n] = rng.standard_normal((n, 4))
    p["opacity"][:n] = rng.standard_normal((n, 1)) * 1.5
    p["segment"][:n] = rng.standard_normal((n, p["segment"].shape[1]))
    m.params = JParams(**{k: jnp.asarray(v, jnp.float32) for k, v in p.items()})
    m.aux = m.aux._replace(alive=m.aux.alive.at[:n].set(True))
    m.active_sh_degree = 3
    return m


def _port_of(jm, **kw):
    d = {k: np.asarray(v) for k, v in jm.params._asdict().items()}
    d["alive"] = np.asarray(jm.aux.alive)
    return params_from_numpy(d, device="cpu", **kw)


@pytest.mark.parametrize("num_class", [0, 2])
def test_render_matches_jax(num_class):
    rng = np.random.default_rng(70 + num_class)
    jm = _jax_model(rng, num_class=num_class)
    tm = _port_of(jm, num_class=num_class)
    cam = make_camera(64, 48)
    bg = np.array([0.1, 0.4, 0.2], np.float32)
    a = jrenderer.render(cam, jm, bg_color=jnp.asarray(bg), backend="pallas",
                         max_instances=1 << 13)
    b = trenderer.render(cam, tm, bg_color=bg, max_instances=1 << 13,
                         device="cpu")
    assert not bool(b["overflow"]) and int(b["num_rendered"]) > 200
    assert int(b["num_rendered"]) == int(a["num_rendered"])
    np.testing.assert_array_equal(b["radii"].numpy(), np.asarray(a["radii"]))
    np.testing.assert_array_equal(b["visibility_filter"].numpy(),
                                  np.asarray(a["visibility_filter"]))
    keys = [("render", "render"), ("alpha", "alpha"), ("depth_raw", "depth"),
            ("depth", "alpha")] + ([("segment", "segment")] if num_class else [])
    for k, tol in keys:
        np.testing.assert_allclose(b[k].numpy(), np.asarray(a[k]),
                                   atol=ATOL[tol], rtol=0, err_msg=k)
    assert (b["segment"] is None) == (num_class == 0)


def test_auto_capacity_matches_jax():
    rng = np.random.default_rng(72)
    jm = _jax_model(rng)
    tm = _port_of(jm)
    cam = make_camera(64, 48)
    assert trenderer._auto_capacity(cam, tm, 64, 48, 1.0) == \
        jrenderer._auto_capacity(cam, jm, 64, 48, 1.0)


def test_empty_model_renders_background():
    m = GaussianModel(3, num_class=2, capacity=64, device="cpu")
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    out = trenderer.render(make_camera(64, 48), m, bg_color=bg,
                           max_instances=1 << 12, device="cpu")
    img = out["render"].numpy()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img, np.broadcast_to(bg[:, None, None],
                                                    img.shape), atol=1e-6)
    assert float(out["alpha"].abs().max()) == 0.0
    assert not bool(out["overflow"])


def test_tiny_capacity_sets_overflow():
    rng = np.random.default_rng(73)
    tm = _port_of(_jax_model(rng))
    out = trenderer.render(make_camera(64, 48), tm, max_instances=128,
                           device="cpu")
    assert bool(out["overflow"])
    for k in ("render", "depth", "alpha"):
        assert torch.isfinite(out[k]).all(), k


def _rasterize_cpu(cfg, **kw):
    rng = np.random.default_rng(74)
    n = 16
    args = [torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)),
            torch.full((n, 3), 0.1), torch.from_numpy(
                rng.standard_normal((n, 4)).astype(np.float32)),
            torch.full((n,), 0.5), torch.zeros(n, 16, 3)]
    if "means3d" in kw:
        args[0] = kw.pop("means3d")
    cam = make_camera(32, 32)
    return rasterize(cfg, *args, cam.world_view_transform,
                     cam.full_proj_transform, cam.camera_center,
                     cam.tan_fovx, cam.tan_fovy, np.zeros(3, np.float32),
                     device="cpu", **kw)


def test_forward_only_and_unported_options_raise():
    cfg = RasterizeConfig(width=32, height=32, max_instances=1 << 12)
    assert _rasterize_cpu(cfg)["render"].shape == (3, 32, 32)
    # an input that requires grad is differentiated, not refused or detached
    means = torch.from_numpy(np.random.default_rng(74).standard_normal(
        (16, 3)).astype(np.float32)).requires_grad_(True)
    out = _rasterize_cpu(cfg, means3d=means)
    (g,) = torch.autograd.grad(out["render"].sum() + out["depth"].sum(), means)
    assert g.shape == (16, 3) and torch.isfinite(g).all()
    assert float(g.abs().max()) > 0.0
    for field, value in (("cull", "exact"), ("max_rows", 1024),
                         ("feat_precision", "bf16"),
                         ("grad_precision", "bf16"), ("mxu_power", True)):
        bad = RasterizeConfig(width=32, height=32, max_instances=1 << 12,
                              **{field: value})
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            _rasterize_cpu(bad)
    for backend in ("cuda", "pallas"):
        bad = RasterizeConfig(width=32, height=32, max_instances=1 << 12,
                              backend=backend)
        with pytest.raises(ValueError, match="backend"):
            _rasterize_cpu(bad)
