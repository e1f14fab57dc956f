"""The benchmark's plain reference against the port's plain versions on the
CPU, on the asset's first gaussians at a small frame: the render, one
step's gradients and the split rule."""
import pytest
import torch

from conftest import ROOT, tiny
from splatbench.harness import scene
from splatbench.reference import camera, splat


def _setup(n=2000):
    cell = tiny("trained262k.view", n)
    cfg = cell.config
    p = scene.load(cfg, ROOT, "cpu")
    pose = camera.poses(cell.traffic["poses"], cfg["width"],
                        cfg["height"])[1]
    return cfg, p, pose


def test_render_matches_port():
    from gsplat_tpu_torch import renderer
    cfg, p, pose = _setup()
    W, H = cfg["width"], cfg["height"]
    ref = splat.render(p, camera.cam(pose, W, H, "cpu"), 3, torch.zeros(3))
    model = scene.port_model(p, cfg, p.xyz.shape[0], "cpu", train=False)
    out = renderer.render(scene.port_camera(pose, cfg), model, device="cpu")
    assert float(ref["alpha"].max()) > 0.5
    torch.testing.assert_close(out["render"], ref["image"], rtol=0,
                               atol=3e-5)
    torch.testing.assert_close(out["depth_raw"], ref["depth"], rtol=1e-5,
                               atol=3e-4)
    torch.testing.assert_close(out["segment"], ref["segment"], rtol=0,
                               atol=3e-5)


@pytest.mark.parametrize("precision,tol", [("f32", 2e-3), ("bf16", 6e-3)])
def test_step_gradients_match_port(precision, tol):
    """One step's loss and gradients in the stated numerics: f32, or the
    training CLI's bf16 features and per-instance gradient rows (where
    rounding boundaries fall apart on a few rows; an f32 reference reads
    2.8e-2 against the port's bf16 here)."""
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.train import trainer
    cfg, p, pose = _setup()
    W, H = cfg["width"], cfg["height"]
    tg = splat.render(p, camera.cam(pose, W, H, "cpu"), 3, torch.zeros(3))
    target = dict(image=tg["image"].clamp(0, 1), depth=tg["depth"],
                  segment=torch.argmax(tg["segment"], 0))
    gen = torch.Generator().manual_seed(3)
    p1 = splat.Params(*[x + 0.02 * torch.randn(x.shape, generator=gen)
                        for x in p])
    hp = dict(lambda_dssim=0.2, lambda_depth=1e-3, lambda_segment=0.01)
    lrs = {f: 1e-3 for f in splat.FIELDS}
    numerics = dict(grad_precision=precision, feat_precision=precision)
    loss, grads, _, _ = splat.train_step(
        p1, splat.zero_moments(p1), lrs, camera.cam(pose, W, H, "cpu"),
        target, hp, 3, torch.zeros(3), numerics=numerics)
    opt = OptimizationParams()
    for k, v in hp.items():
        setattr(opt, k, v)
    rc = RasterizeConfig(width=W, height=H, sh_degree=3, num_class=2,
                         max_instances=1 << 18, **numerics)
    loss_fn = trainer.make_loss_fn(rc, opt, 3, "L1_loss", True,
                                   torch.zeros(3), device="cpu")
    model = scene.port_model(p1, cfg, p1.xyz.shape[0], "cpu", train=False)
    leaves = type(model.params)(*[x.detach().requires_grad_(True)
                                  for x in model.params])
    batch = trainer.camera_batch(
        scene.port_camera(pose, cfg, target["image"].numpy(),
                          target["depth"][None].numpy(),
                          target["segment"].numpy()), device="cpu")
    m2d = torch.zeros((p1.xyz.shape[0], 2), requires_grad=True)
    port_loss, _ = loss_fn(leaves, m2d, batch)
    port = torch.autograd.grad(port_loss, list(leaves))
    assert abs(float(port_loss.detach()) - loss) <= 1e-5 * loss
    for f, a, b in zip(splat.FIELDS, port, grads):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * scale, f


def test_split_matches_port_densify():
    from gsplat_tpu_torch.models import adam, densify
    from gsplat_tpu_torch.models.gaussians import GaussianAux
    cfg, p, _ = _setup(500)
    P = p.xyz.shape[0]
    ref = splat.split(p, torch.Generator().manual_seed(4))
    draw = torch.randn((2, P, 3), generator=torch.Generator().manual_seed(4))
    model = scene.port_model(p, cfg, 3 * P, "cpu", train=True)
    aux = GaussianAux(model.aux.alive, model.aux.max_radii2d,
                      torch.ones(3 * P), torch.ones(3 * P))
    noise = torch.cat([draw, torch.zeros((2, 2 * P, 3))], 1)
    params, _, _, stats = densify.densify_and_prune(
        model.params, aux, adam.init(model.params), 0.0, 0.0, 1e-9, 20,
        0.01, use_screen_size=False, noise=noise)
    assert int(stats.n_split) == P
    slots = torch.arange(P)
    for k in range(2):
        for f, x in zip(splat.FIELDS, params):
            torch.testing.assert_close(x[P + 2 * slots + k],
                                       getattr(ref, f)[k * P + slots],
                                       rtol=1e-6, atol=1e-6)
