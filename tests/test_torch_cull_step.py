"""Exact cull on the port's training path on the CPU: ``rasterize`` with
and without the cull (the same images and gradients, as the JAX test
``test_exact_cull_image_and_grad_parity`` holds its own), and one
exact-cull ``make_train_step`` against the JAX step from a shared warm
state."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from gsplat_tpu import config as jconfig
from gsplat_tpu.models import adam as jadam
from gsplat_tpu.models import gaussians as jgauss
from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
from gsplat_tpu.train import trainer as jtrainer
from gsplat_tpu_torch import config as tconfig
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from gsplat_tpu_torch.train import schedules as tsched
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_helpers import (GAUSS_KEYS, cam_np, make_camera,
                           make_gaussians_np, model_state_np, tree_np)

CULL = dict(cull="exact", max_rows=1 << 12)


def test_exact_cull_keeps_images_and_gradients():
    """The port with and without the cull (JAX test
    ``test_exact_cull_image_and_grad_parity``): fewer instances, the same
    images (rtol 1e-5; atol 1e-6 for rgb and T_final, 1e-5 for depth) and
    gradients of the same loss within rtol 3e-3, atol 1e-3."""
    rng = np.random.default_rng(76)
    g = make_gaussians_np(rng, n=400)
    cam = make_camera(96, 64)

    def run(cull):
        cfg = RasterizeConfig(width=96, height=64, max_instances=1 << 14,
                              cull=cull, max_rows=1 << 12)
        leaves = [torch.from_numpy(g[k]).requires_grad_(True)
                  for k in GAUSS_KEYS]
        out = rasterize(cfg, *leaves, **cam_np(cam),
                        bg=np.array([0.15, 0.3, 0.1], np.float32),
                        device="cpu")
        loss = ((out["render"] ** 2).sum() + out["depth"].sum()
                + (out["alpha"] ** 2).sum())
        return out, torch.autograd.grad(loss, leaves)

    out0, g0 = run("none")
    out1, g1 = run("exact")
    assert int(out1["num_rendered"]) < int(out0["num_rendered"])
    for k, atol in (("render", 1e-6), ("depth", 1e-5), ("T_final", 1e-6)):
        np.testing.assert_allclose(out1[k].detach().numpy(),
                                   out0[k].detach().numpy(), rtol=1e-5,
                                   atol=atol, err_msg=k)
    for k, a, b in zip(GAUSS_KEYS, g1, g0):
        assert float(b.abs().max()) > 0.0, k
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-3,
                                   atol=1e-3, err_msg=k)


def test_exact_cull_train_step_matches_jax():
    """One ``make_train_step`` with ``cull="exact"`` against the JAX step
    (compiled once here) from a shared warm state, at the tolerances of
    ``tests/test_torch_train.py::test_train_step_matches_jax``: a cold JAX
    step gives the parameters, the first moments and the gradients' scale;
    the second moment is the square of each group's largest gradient and
    the step count 100 (a first Adam step moves every entry by
    lr * sign(g), which no tolerance could hold across two packages)."""
    W, H, n, cap = 64, 32, 150, 192
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    rng = np.random.default_rng(77)
    p0 = model_state_np(rng, n=n, capacity=cap)
    alive = p0.pop("alive")
    cam = make_camera(W, H)
    cam.image = rng.uniform(size=(3, H, W)).astype(np.float32)
    depth = rng.uniform(0.2, 2.0, (1, H, W)).astype(np.float32)
    seg = rng.integers(0, 2, (H, W)).astype(np.int32)
    fields = tgauss.GaussianParams._fields
    lrs = tsched.make_lr_fn(tconfig.OptimizationParams(), 1.0)(100)
    jlrs = {k: jnp.float32(v) for k, v in lrs.items()}
    jstep = jtrainer.make_train_step(
        JCfg(width=W, height=H, num_class=2, max_instances=1 << 13,
             backend="pallas", **CULL),
        jconfig.OptimizationParams(), 3, "L1_loss", True, jnp.asarray(bg))
    tstep = ttrainer.make_train_step(
        RasterizeConfig(width=W, height=H, num_class=2,
                        max_instances=1 << 13, **CULL),
        tconfig.OptimizationParams(), 3, "L1_loss", True, bg, device="cpu")
    jbatch = jtrainer.camera_batch(cam, gt_depth=depth, gt_seg=seg)
    key = jax.random.PRNGKey(0)

    def jtree(d):
        return jgauss.GaussianParams(**{k: jnp.asarray(d[k]) for k in fields})

    jaux0 = jgauss.empty_aux(cap)._replace(alive=jnp.asarray(alive))
    jp1, jo1, ja1, _ = jstep(jtree(p0), jadam.init(jtree(p0)), jaux0, jbatch,
                             jlrs, key)
    params, mu, aux = tree_np(jp1), tree_np(jo1.mu), tree_np(ja1)
    gmax = {k: float(np.abs(mu[k]).max()) / 0.1 for k in fields}
    nu = {k: (np.float32(gmax[k] ** 2) * alive.reshape(
        (-1,) + (1,) * (mu[k].ndim - 1)) * np.ones_like(mu[k])).astype(
        np.float32) for k in fields}
    jp, jo, ja, jm = jstep(
        jtree(params), jadam.AdamState(jnp.int32(100), jtree(mu), jtree(nu)),
        jgauss.GaussianAux(**{k: jnp.asarray(v) for k, v in aux.items()}),
        jbatch, jlrs, key)
    tp, to, ta, tm = tstep(
        tgauss.params_from_numpy(dict(params, alive=alive), device="cpu",
                                 num_class=2).params,
        tgauss.adam_state_from_numpy(100, mu, nu, device="cpu"),
        tgauss.aux_from_numpy(aux, device="cpu"),
        ttrainer.camera_batch(cam, gt_depth=depth, gt_seg=seg, device="cpu"),
        lrs)

    for k in ("num_rendered", "num_padded", "n_visible"):
        assert int(tm[k]) == int(jm[k]), k
    assert int(tm["num_rendered"]) > 100 and not bool(tm["overflow"])
    for k in ("loss", "l1", "depth_loss", "seg_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-5,
                                   err_msg=k)
    for k in fields:
        np.testing.assert_allclose(getattr(to.mu, k).numpy(),
                                   np.asarray(getattr(jo.mu, k)), rtol=0,
                                   atol=1e-4 * gmax[k], err_msg=f"mu.{k}")
        np.testing.assert_allclose(getattr(to.nu, k).numpy(),
                                   np.asarray(getattr(jo.nu, k)), rtol=1e-6,
                                   atol=2e-6 * gmax[k] ** 2,
                                   err_msg=f"nu.{k}")
        np.testing.assert_allclose(getattr(tp, k).numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-6,
                                   atol=1e-4 * lrs[k], err_msg=f"params.{k}")
    for k in ("alive", "denom", "max_radii2d"):
        np.testing.assert_array_equal(getattr(ta, k).numpy(),
                                      np.asarray(getattr(ja, k)), err_msg=k)
    acc_j = np.asarray(ja.xyz_gradient_accum)
    np.testing.assert_allclose(ta.xyz_gradient_accum.numpy(), acc_j,
                               atol=1e-3 * np.abs(acc_j).max())
