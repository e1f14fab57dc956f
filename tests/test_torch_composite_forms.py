"""The JAX trainer's default numerics through the port on the CPU against
the JAX package's Pallas path (interpret mode): ``rasterize`` with the
packed bf16 features and bf16 gradient rows, with the tile-relative
quadratic power (``mxu_power``), and with all three, in images and input
gradients; and one ``make_train_step`` step in the JAX ``Trainer``'s
default configuration from a shared warm state.

The two packages compute the same form here, so the port's own parity
tolerances hold (tests/test_torch_composite.py, test_torch_composite_bwd.py):
image 3e-5, depth 3e-4, gradients 1e-3 of each input's largest.  The quad
form sums six basis terms that grow with TILE_X^2 and cancel (to a power
near -1 from terms of hundreds where a mean lies far outside its tile), and
the JAX package sums them in a matrix product, the port left to right: the
power differs by up to ~3e-4 between the two, so an image value by up to
~1e-4.  There the images are held to the JAX package's own tolerance
between two summation orders of this power (its MXU and VPU forms,
tests/test_pallas_composite.py:140-175: image 5e-5, depth 5e-4), and the
gradients to the port's, each scaled by (TILE_X/16)^2 as that test
scales its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
from gsplat_tpu.ops.rasterize import rasterize as jrast
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.ops.preprocess import TILE_X
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize

from torch_helpers import (ATOL, GAUSS_KEYS, cam_np, make_camera,
                           make_gaussians_np, step_from_warm_state, to_jax)

QUAD_SCALE = (TILE_X / 16.0) ** 2
QUAD_ATOL = {k: (5e-4 if k == "depth" else 5e-5) * QUAD_SCALE for k in ATOL}
# the JAX Trainer's configuration (gsplat_tpu/train/trainer.py:252-254, 384)
DEFAULTS = dict(grad_precision="bf16", feat_precision="bf16", mxu_power=True)
CASES = {
    "packed": (dict(feat_precision="bf16", grad_precision="bf16"), 0),
    "quad": (dict(mxu_power=True), 0),
    "defaults": (DEFAULTS, 2),
}


def _port(cfg, g, c, bg, names, num_class):
    pt = {k: torch.from_numpy(g[k]).requires_grad_(True) for k in names}
    out = rasterize(cfg, *[pt[k] for k in GAUSS_KEYS], **c, bg=bg,
                    segments=pt["segments"] if num_class else None,
                    device="cpu")
    return out, pt


@pytest.mark.parametrize("case", list(CASES))
def test_rasterize_forms_match_jax(case):
    kw, num_class = CASES[case]
    quad = bool(kw.get("mxu_power"))
    scale = QUAD_SCALE if quad else 1.0
    atol = QUAD_ATOL if quad else ATOL
    rng = np.random.default_rng(700 + len(case))
    W, H = 64, 48
    g = make_gaussians_np(rng, n=300, num_class=num_class)
    c = cam_np(make_camera(W, H))
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    tgt = rng.uniform(size=(3, H, W)).astype(np.float32)
    wseg = rng.uniform(size=(max(num_class, 1), H, W)).astype(np.float32)
    names = list(GAUSS_KEYS) + (["segments"] if num_class else [])
    base = dict(width=W, height=H, num_class=num_class,
                max_instances=1 << 13)

    def loss(out, xp, asarray):
        val = (xp.mean((out["render"] - asarray(tgt)) ** 2)
               + 0.05 * xp.mean(out["depth"]) + 0.02 * xp.mean(out["alpha"])
               + 0.1 * xp.mean(out["T_final"]))
        if num_class:
            val = val + 0.03 * xp.mean(out["segment"] * asarray(wseg))
        return val

    jcfg = JCfg(backend="pallas", **base, **kw)

    def jloss(p):
        out = jrast(jcfg, *[p[k] for k in GAUSS_KEYS], **to_jax(c),
                    bg=jnp.asarray(bg), segments=p.get("segments"))
        return loss(out, jnp, jnp.asarray), out

    (_, jo), gj = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(g[k]) for k in names})
    to, pt = _port(RasterizeConfig(**base, **kw), g, c, bg, names, num_class)
    gt = torch.autograd.grad(loss(to, torch, torch.from_numpy),
                             [pt[k] for k in names])

    keys = ["render", "depth", "alpha", "T_final"] + (
        ["segment"] if num_class else [])
    for k in keys:
        np.testing.assert_allclose(to[k].detach().numpy(), np.asarray(jo[k]),
                                   rtol=0, atol=atol[k], err_msg=k)
    assert int(to["num_rendered"]) == int(jo["num_rendered"]) > 300
    for k, v in zip(names, gt):
        want = np.asarray(gj[k])
        assert torch.isfinite(v).all(), k
        top = np.abs(want).max()
        assert top > 0, k
        np.testing.assert_allclose(v.numpy() / top, want / top,
                                   atol=1e-3 * scale, err_msg=f"grad {k}")
    if kw.get("feat_precision") == "bf16":
        # T_final sees only the geometry, which stays f32: the port's f32
        # and packed forms give the same bits (as the JAX test requires)
        f32 = RasterizeConfig(**base, **dict(kw, feat_precision="f32"))
        t32, _ = _port(f32, g, c, bg, names, num_class)
        np.testing.assert_array_equal(to["T_final"].detach().numpy(),
                                      t32["T_final"].detach().numpy())


# --- one train step in the JAX Trainer's configuration ------------------------

PFIELDS = tgauss.GaussianParams._fields


@pytest.fixture(scope="module")
def default_step():
    """One JAX train step in the Trainer's configuration (compiled once)
    and the port's, both from one state with dead rows and warm Adam
    moments (tests/test_torch_train.py's construction)."""
    return step_from_warm_state(760, **DEFAULTS)


def test_default_train_step_matches_jax(default_step):
    """The loss terms within 2e-5, the moments and parameters at
    tests/test_torch_train.py's tolerances scaled for the quad form."""
    s = default_step
    (jp, jo, ja, jm), (tp, to, ta, tm) = s["jout"], s["tout"]
    for k in ("num_rendered", "num_padded", "n_visible"):
        assert int(tm[k]) == int(jm[k]), k
    assert int(tm["num_rendered"]) > 100 and not bool(tm["overflow"])
    for k in ("loss", "l1", "depth_loss", "seg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   rtol=2e-5 * QUAD_SCALE, err_msg=k)
    assert int(to.count) == int(jo.count) == 101
    dead = ~s["alive"]
    for k in PFIELDS:
        gmax, lr = s["gmax"][k], s["lrs"][k]
        assert gmax > 0.0, k
        mu_t, mu_j = getattr(to.mu, k).numpy(), np.asarray(getattr(jo.mu, k))
        np.testing.assert_allclose(mu_t, mu_j, rtol=0,
                                   atol=1e-4 * gmax * QUAD_SCALE,
                                   err_msg=f"mu.{k}")
        np.testing.assert_allclose(getattr(to.nu, k).numpy(),
                                   np.asarray(getattr(jo.nu, k)), rtol=1e-6,
                                   atol=2e-6 * gmax ** 2 * QUAD_SCALE,
                                   err_msg=f"nu.{k}")
        p_t, p_j = getattr(tp, k).numpy(), np.asarray(getattr(jp, k))
        np.testing.assert_allclose(p_t, p_j, rtol=1e-6,
                                   atol=1e-4 * lr * QUAD_SCALE,
                                   err_msg=f"params.{k}")
        assert np.isfinite(p_t).all() and np.isfinite(mu_t).all(), k
        assert np.abs(mu_t[dead]).max() == 0.0, k
    for k in ("alive", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)), err_msg=k)
    acc_j = np.asarray(ja.xyz_gradient_accum)
    np.testing.assert_allclose(ta.xyz_gradient_accum.numpy(), acc_j,
                               atol=1e-3 * QUAD_SCALE * np.abs(acc_j).max())
