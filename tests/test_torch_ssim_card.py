"""K7 and K8 (``gsplat_tpu_torch/csrc/ssim.cu``) on the card: against their
plain versions at 1920x1080 and at a ragged 1001x1777, bit-equal between
two launches, and inside the training steps at the training benchmark's
524,288-slot model of ``assets/trained_scene_big.npz`` (one launch of each
a step, no readback added).

Marked ``card``; they skip without a CUDA card.  On a machine with one,
from the root of a checkout (the suite's conftest imports JAX, which that
machine need not have):

    python -m pytest --noconftest -m card tests/test_torch_ssim_card.py
"""
import json
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "splatbench", "configs", "trained262k.json")
TRAFFIC = os.path.join(ROOT, "splatbench", "traffic", "train.json")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def images(shape, seed, dev):
    """A smooth image in [0, 1] with a flat black band (a render's empty
    sky) and its target: the image with noise added, clamped."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    C, H, W = shape
    coarse = torch.rand((1, C, H // 16 + 2, W // 16 + 2), generator=gen,
                        device=dev)
    x = torch.nn.functional.interpolate(coarse, size=(H, W), mode="bilinear",
                                        align_corners=False)[0]
    x[:, : H // 5] = 0.0
    y = (x + 0.05 * torch.randn(shape, generator=gen, device=dev)).clamp(0, 1)
    return x.contiguous(), y.contiguous()


@pytest.mark.card
@pytest.mark.parametrize("shape", [(3, 1080, 1920), (3, 1001, 1777)])
def test_k7_and_k8_match_their_plain_versions(shape):
    """K7's mean within 1e-6 relative of ssim_plain's (only the reduction
    order differs); K8's gradient per entry within 1e-4 relative plus 1e-4
    of the plain version's largest magnitude; one launch of each."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.train import losses as L
    dev = _card()
    x, y = images(shape, 21, dev)
    before = dict(_kernels.launch_counts)
    got = L.ssim_forward(x, y)
    want = L.ssim_plain(x, y)
    assert got.shape == () and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    g = torch.tensor(-0.2, device=dev)
    d_got = L.ssim_backward(x, y, g)
    d_want = L.ssim_backward_plain(x, y, g)
    assert bool(torch.isfinite(d_got).all())
    floor = 1e-4 * float(d_want.abs().max())
    torch.testing.assert_close(d_got, d_want, rtol=1e-4, atol=floor)
    for k in ("ssim_forward", "ssim_backward"):
        assert _kernels.launch_counts[k] - before[k] == 1, k


@pytest.mark.card
def test_k7_and_k8_are_deterministic_and_refuse_what_they_do_not_take():
    """Two launches of each give the same bits, through ``ssim`` and its
    autograd gradient too; the wrapper raises on another window, dtype or
    shape, and on an img2 that needs a gradient."""
    from gsplat_tpu_torch.train import losses as L
    dev = _card()
    x, y = images((3, 1080, 1920), 22, dev)
    g = torch.tensor(-0.2, device=dev)
    assert torch.equal(L.ssim_forward(x, y), L.ssim_forward(x, y))
    assert torch.equal(L.ssim_backward(x, y, g), L.ssim_backward(x, y, g))
    xg = x.clone().requires_grad_(True)
    v = L.ssim(xg, y)
    (dx,) = torch.autograd.grad(v, xg, g)
    assert torch.equal(v, L.ssim_forward(x, y))
    assert torch.equal(dx, L.ssim_backward(x, y, g))
    for bad in (lambda: L.ssim(x, y, window_size=9),
                lambda: L.ssim(x.double(), y.double()),
                lambda: L.ssim(x, y[:, 1:]),
                lambda: L.ssim(x, y.clone().requires_grad_(True))):
        with pytest.raises(ValueError):
            bad()


@pytest.fixture(scope="module")
def bench():
    """The benchmark's model (262,046 gaussians in 524,288 slots, SH degree
    3, two segment classes), one training view's batch and its
    configuration."""
    dev = _card()
    import sys
    sys.path.insert(0, ROOT)
    from splatbench.harness import scene
    from splatbench.reference import camera
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.train import trainer
    with open(CONFIG) as f:
        cfg = json.load(f)
    with open(TRAFFIC) as f:
        views = json.load(f)["views"]
    model = scene.port_model(scene.load(cfg, ROOT, dev), cfg,
                             cfg["train_slots"], dev, train=True)
    pose = camera.poses(views, cfg["width"], cfg["height"])[1]
    target = renderer.render(scene.port_camera(pose, cfg), model, device=dev)
    cam = scene.port_camera(
        pose, cfg, target["render"].clamp(0, 1).cpu().numpy(),
        target["depth_raw"].cpu().numpy(),
        torch.argmax(target["segment"], dim=0).to(torch.uint8).cpu().numpy(),
        uid=1)
    return model, trainer.camera_batch(cam, device=dev), cfg


@pytest.mark.card
def test_training_steps_launch_k7_and_k8_once(bench, monkeypatch):
    """One ``make_train_step`` and one ``make_appearance_step`` step in the
    benchmark's numerics: K7 and K8 launch once each a step, no value is
    read back, and the image each hands ``ssim`` (the render's output, the
    appearance-scaled render) is a contiguous float32 [3, H, W]."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.models import appearance as app_lib
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.train import losses as L
    from gsplat_tpu_torch.train import schedules, trainer
    model, batch, cfg = bench
    dev = torch.device("cuda")
    num = cfg["numerics"]
    rc = RasterizeConfig(width=cfg["width"], height=cfg["height"],
                         sh_degree=cfg["sh_degree"],
                         num_class=cfg["num_class"], max_instances=1 << 23,
                         grad_precision=num["grad_precision"],
                         feat_precision=num["feat_precision"])
    opt = OptimizationParams()
    bg = torch.zeros(3, device=dev)
    args = (rc, opt, cfg["sh_degree"], "L1_loss", True, bg)
    app = app_lib.AppearanceOptimizer(4, device=dev)
    app_step = trainer.make_appearance_step(*args, device=dev)
    steps = {"train": trainer.make_train_step(*args, device=dev),
             "appearance": lambda *s: app_step(*s[:3], app.params,
                                               app.opt_state, *s[3:])}
    lrs = schedules.make_lr_fn(opt, 1.0)(1)
    state = (model.params, model.opt_state, model.aux)
    seen = []
    plain_ssim = L.ssim

    def recorded(img1, img2, window_size=11):
        seen.append((tuple(img1.shape), img1.dtype, img1.is_contiguous()))
        return plain_ssim(img1, img2, window_size)

    monkeypatch.setattr(L, "ssim", recorded)
    shape = (3, cfg["height"], cfg["width"])
    for name, step in steps.items():
        step(*state, batch, lrs)                   # warm
        torch.cuda.synchronize()
        seen.clear()
        before = dict(_kernels.launch_counts)
        out = step(*state, batch, lrs)
        torch.cuda.synchronize()
        delta = {k: _kernels.launch_counts.get(k, 0) - before.get(k, 0)
                 for k in ("ssim_forward", "ssim_backward", "host_syncs")}
        assert delta == {"ssim_forward": 1, "ssim_backward": 1,
                         "host_syncs": 0}, name
        assert seen == [(shape, torch.float32, True)], name
        assert not bool(out[-1]["overflow"]), name
