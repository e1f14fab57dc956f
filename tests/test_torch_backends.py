"""The render backends of the port on the CPU: the plain-torch tiled
compositor (``ops/composite_tiled.py``, the ``"jnp"`` and ``"reference"``
backends) against the JAX package's ``composite_tiled`` and its ``"jnp"``
rasterize on the same numpy inputs, ``"pallas"`` against ``"auto"``, a
train step on the tiled path, and unknown backends refused.

Tolerances are the JAX tests' between the tiled and the Pallas paths
(tests/test_pallas_composite.py:35-43, :99): images within ``ATOL``,
gradients within 1e-3 of each field's largest.  One JAX rasterize is
compiled in this file (the ``"jnp"`` one), one JAX preprocess and binning,
and one JAX ``composite_tiled`` with its gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops import binning as jbin
from gsplat_tpu.ops import composite_tiled as jtiled
from gsplat_tpu.ops import preprocess as jpre
from gsplat_tpu.ops.rasterize import RasterizeConfig as JCfg
from gsplat_tpu.ops.rasterize import rasterize as jrast
from gsplat_tpu_torch import renderer
from gsplat_tpu_torch.config import OptimizationParams
from gsplat_tpu_torch.models import adam as tadam
from gsplat_tpu_torch.models import gaussians as tgauss
from gsplat_tpu_torch.ops import composite_tiled as ttiled
from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y
from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
from gsplat_tpu_torch.train import schedules as tsched
from gsplat_tpu_torch.train import trainer as ttrainer

from torch_helpers import (ATOL, GAUSS_KEYS, cam_np, jax_pre_to_torch,
                           make_camera, make_gaussians_np, model_state_np,
                           to_jax)

W, H = 64, 64
K_MAX = 48          # under the heaviest tile's count: the cap is exercised
GRAD_ATOL = 1e-3    # of each field's largest (test_pallas_composite.py:99)


def _close_scaled(got, want, err_msg):
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, atol=GRAD_ATOL,
                               rtol=0, err_msg=err_msg)


def test_composite_tiled_matches_jax():
    """One binning (JAX's, with no pads) into both compositors: images and
    T_final within ATOL, the gradients of one loss in means2d, conic,
    opacity and the features within 1e-3 of each field's largest; tiles
    over ``k_max`` cut; under autograd (each tile batch checkpointed) the
    forward equals the one without."""
    rng = np.random.default_rng(31)
    g = make_gaussians_np(rng, n=300, spread=0.8)
    c = cam_np(make_camera(W, H))
    gx, gy = (W + TILE_X - 1) // TILE_X, (H + TILE_Y - 1) // TILE_Y

    @jax.jit
    def prep(*arrays):
        pre = jpre.preprocess(*arrays[:5], 3, *arrays[5:], c["tan_fovx"],
                              c["tan_fovy"], W, H)
        return pre, jbin.bin_gaussians(pre, gx, gy, 1 << 14, align=1,
                                       expand_impl="xla")

    pj, jb = prep(*[jnp.asarray(a) for a in [g[k] for k in GAUSS_KEYS] + [
        c["viewmatrix"], c["projmatrix"], c["campos"]]])
    pt = jax_pre_to_torch(pj)
    tb = type(jb)(*[torch.from_numpy(np.array(x)) for x in jb])
    P = pj.means2d.shape[0]
    feats = rng.uniform(0, 1, (P, 5)).astype(np.float32)
    cot = rng.standard_normal((H, W, 5)).astype(np.float32)
    cot_t = rng.standard_normal((H, W)).astype(np.float32)
    assert int(np.asarray(jb.tile_count).max()) > K_MAX

    def jloss(m2d, conic, opac, ft):
        img, T = jtiled.composite_tiled(m2d, conic, opac, ft, jb, W, H,
                                        k_max=K_MAX, tile_batch=3)
        return jnp.sum(img * cot) + jnp.sum(T * cot_t), (img, T)

    jargs = (pj.means2d, pj.conic, pj.opacity, jnp.asarray(feats))
    (_, (jimg, jT)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True))(*jargs)

    targs = [pt.means2d.clone().requires_grad_(True),
             pt.conic.clone().requires_grad_(True),
             pt.opacity.clone().requires_grad_(True),
             torch.from_numpy(feats).requires_grad_(True)]
    img, T = ttiled.composite_tiled(*targs, tb, W, H, k_max=K_MAX,
                                    tile_batch=3)
    (torch.sum(img * torch.from_numpy(cot))
     + torch.sum(T * torch.from_numpy(cot_t))).backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg),
                               atol=ATOL["render"], rtol=0)
    np.testing.assert_allclose(T.detach().numpy(), np.asarray(jT),
                               atol=ATOL["T_final"], rtol=0)
    for name, a, b in zip(("means2d", "conic", "opacity", "feats"), targs,
                          jgrads):
        _close_scaled(a.grad.numpy(), np.asarray(b), name)

    with torch.no_grad():
        img2, T2 = ttiled.composite_tiled(*targs, tb, W, H, k_max=K_MAX,
                                          tile_batch=3)
    assert torch.equal(img2, img.detach()) and torch.equal(T2, T.detach())


def _rasterize(cfg, g, cam, bg, **kw):
    return rasterize(cfg, *[torch.from_numpy(g[k]) for k in GAUSS_KEYS],
                     **cam_np(cam), bg=bg,
                     segments=torch.from_numpy(g["segments"]), device="cpu",
                     **kw)


def test_rasterize_backends_match_jax():
    """``rasterize`` with ``"jnp"`` and ``"reference"`` equal each other bit
    for bit and JAX's ``"jnp"`` (its ``"reference"`` is the same path)
    within ATOL, with the same binning counts; ``"pallas"`` equals
    ``"auto"`` bit for bit; the jnp path is within ATOL of ``"auto"``
    where no tile is cut; an unknown backend raises."""
    rng = np.random.default_rng(32)
    g = make_gaussians_np(rng, n=300, num_class=2, spread=0.8)
    cam = make_camera(W, H)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    kw = dict(width=W, height=H, num_class=2, max_instances=1 << 14,
              k_max=K_MAX)
    jo = jrast(JCfg(backend="jnp", **kw),
               *[jnp.asarray(g[k]) for k in GAUSS_KEYS], **to_jax(cam_np(cam)),
               bg=jnp.asarray(bg), segments=jnp.asarray(g["segments"]))
    outs = {b: _rasterize(RasterizeConfig(backend=b, **kw), g, cam, bg)
            for b in ("jnp", "reference", "auto", "pallas")}
    for k in outs["jnp"]:
        assert torch.equal(outs["reference"][k], outs["jnp"][k]), k
        assert torch.equal(outs["pallas"][k], outs["auto"][k]), k
    for k in ("render", "alpha", "segment", "depth", "T_final"):
        np.testing.assert_allclose(outs["jnp"][k].numpy(), np.asarray(jo[k]),
                                   atol=ATOL[k], rtol=0, err_msg=k)
    for k in ("num_rendered", "num_padded", "overflow", "radii",
              "visibility"):
        np.testing.assert_array_equal(outs["jnp"][k].numpy(),
                                      np.asarray(jo[k]), err_msg=k)
    assert int(outs["jnp"]["num_padded"]) == int(
        outs["jnp"]["num_rendered"])
    assert int(outs["auto"]["num_padded"]) > int(outs["auto"]["num_rendered"])

    full = _rasterize(RasterizeConfig(backend="jnp", **dict(kw, k_max=1024)),
                      g, cam, bg)
    for k in ("render", "alpha", "segment", "depth", "T_final"):
        np.testing.assert_allclose(full[k].numpy(), outs["auto"][k].numpy(),
                                   atol=ATOL[k], rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="backend"):
        _rasterize(RasterizeConfig(backend="tiled", **kw), g, cam, bg)


def test_train_step_on_the_tiled_backend():
    """``make_train_step`` with ``backend="jnp"`` from the state of a
    ``"auto"`` step (cold Adam, f32): the first moments (0.1 times the
    gradients) within 1e-3 of each field's largest of the ``"auto"``
    step's, the densification statistics likewise, the same loss within
    1e-5 relative, finite parameters."""
    rng = np.random.default_rng(33)
    p = model_state_np(rng, n=150, capacity=192)
    alive = p.pop("alive")
    cam = make_camera(W, 32)
    cam.image = rng.uniform(size=(3, 32, W)).astype(np.float32)
    seg = rng.integers(0, 2, (32, W)).astype(np.int32)
    batch = ttrainer.camera_batch(cam, gt_seg=seg, device="cpu")
    opt = OptimizationParams()
    lrs = tsched.make_lr_fn(opt, 1.0)(100)
    bg = np.array([0.1, 0.3, 0.2], np.float32)
    res = {}
    for backend in ("auto", "jnp"):
        cfg = RasterizeConfig(width=W, height=32, num_class=2,
                              max_instances=1 << 13, backend=backend)
        step = ttrainer.make_train_step(cfg, opt, 3, None, True, bg,
                                        device="cpu")
        m = tgauss.params_from_numpy(dict(p, alive=alive), device="cpu",
                                     num_class=2)
        res[backend] = step(m.params, tadam.init(m.params), m.aux, batch, lrs)
    (pa, oa, aa, ma), (pj, oj, aj, mj) = res["auto"], res["jnp"]
    for k in tgauss.GaussianParams._fields:
        _close_scaled(getattr(oj.mu, k).numpy(), getattr(oa.mu, k).numpy(),
                      f"mu.{k}")
        assert torch.isfinite(getattr(pj, k)).all(), k
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        _close_scaled(getattr(aj, k).numpy(), getattr(aa, k).numpy(), k)
    assert float(ma["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-5)
    assert float(np.abs(oj.mu.xyz.numpy()).max()) > 0


def test_renderer_backends_and_refusals():
    """``renderer.render`` on a model with dead slots and a bbox mask:
    ``"jnp"`` equals ``"reference"`` and ``"pallas"`` equals ``"auto"`` bit
    for bit, the two pairs within ATOL; the ``Trainer`` and ``render``
    refuse an unknown backend."""
    rng = np.random.default_rng(34)
    p = model_state_np(rng, n=120, capacity=160)
    m = tgauss.params_from_numpy(p, device="cpu", num_class=2)
    cam = make_camera(W, 48)
    mask = rng.uniform(size=160) < 0.8
    outs = {b: renderer.render(cam, m, bg_color=np.array([0.1, 0.2, 0.3]),
                               bbox_mask=mask, backend=b, device="cpu")
            for b in ("auto", "pallas", "jnp", "reference")}
    for k in ("render", "depth", "alpha", "segment"):
        assert torch.equal(outs["pallas"][k], outs["auto"][k]), k
        assert torch.equal(outs["reference"][k], outs["jnp"][k]), k
        tol = ATOL["depth"] if k == "depth" else ATOL[k]
        np.testing.assert_allclose(outs["jnp"][k].numpy(),
                                   outs["auto"][k].numpy(), atol=tol,
                                   rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="backend"):
        renderer.render(cam, m, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        ttrainer.Trainer(m, None, OptimizationParams(), backend="tpu")
