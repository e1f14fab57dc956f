"""``correct`` on the CPU at a small size: a sound run of each kind comes
out correct, and a run whose timed path is broken underneath comes out not
correct, once for each fault the cell can have (the training step returns
its state unchanged; the loss leaves out half of the image and takes its
mean over the rest; the viewer answers with a stale frame; the frame's bytes
are altered where they are made).  The control (the reference in bfloat16
put in the program's place) fails the cell's limits too."""
import pytest
import torch

from conftest import run_tiny, tiny


@pytest.mark.parametrize("name,trace,n", [("trained262k.train", False, 3000),
                                          ("trained262k.view", True, 3000),
                                          ("split2m.train", True, 375),
                                          ("split2m.view", False, 375)])
def test_sound_run_is_correct(name, trace, n):
    res = run_tiny(name, trace=trace, n=n)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from gsplat_tpu_torch.train import trainer
    make = trainer.make_train_step

    def broken(*a, **k):
        step = make(*a, **k)

        def same(params, opt_state, aux, batch, lrs, generator=None,
                 draws=None):
            m = step(params, opt_state, aux, batch, lrs, generator, draws)
            return params, opt_state, aux, m[-1]
        return same
    monkeypatch.setattr(trainer, "make_train_step", broken)


def _half_batch(monkeypatch):
    from gsplat_tpu_torch.train import trainer
    make = trainer.make_image_loss

    def broken(*a, **k):
        loss = make(*a, **k)

        def top_half(image, depth, segment, batch, generator=None,
                     draws=None):
            h = image.shape[1] // 2
            b = dict(batch, gt_image=batch["gt_image"][:, :h],
                     gt_depth=batch["gt_depth"][:, :h],
                     gt_seg=batch["gt_seg"][:h])
            return loss(image[:, :h], depth[:h], segment[:, :h], b,
                        generator, draws)
        return top_half
    monkeypatch.setattr(trainer, "make_image_loss", broken)


def _stale_frame(monkeypatch):
    from gsplat_tpu_torch import renderer
    render, prev = renderer.render, []

    def stale(*a, **k):
        out = render(*a, **k)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out
    monkeypatch.setattr(renderer, "render", stale)


def _altered_bytes(monkeypatch):
    from gsplat_tpu_torch.viz import network_gui
    from splatbench.harness.calibrate import alter
    frame_bytes = network_gui.frame_bytes

    def altered(image):
        return memoryview(alter(frame_bytes(image), image.shape[2],
                                image.shape[1]))
    monkeypatch.setattr(network_gui, "frame_bytes", altered)


@pytest.mark.parametrize("name,fault", [
    ("trained262k.train", _state_unchanged),
    ("trained262k.train", _half_batch),
    ("trained262k.view", _stale_frame),
    ("trained262k.view", _altered_bytes)])
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    res = run_tiny(name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", ["trained262k.train", "trained262k.view"])
def test_control_is_not_correct(name):
    import time
    from splatbench.harness import bench, check, train, view
    from splatbench.reference import camera, splat
    cell = tiny(name)
    ctx = bench.Ctx(cell, 7, 0.0, False, "cpu", time.perf_counter(),
                    budget=1 << 22)
    cfg = cell.config
    if cell.traffic["kind"] == "train":
        prep = train.prepare(ctx)
        p0 = prep["base"]
        args = (p0, prep["views"], [0, 1, 2], prep["tg"], cfg, cell.traffic,
                ctx.device)
        ref = train.reference_steps(*args, budget=ctx.budget)
        ctl = train.reference_steps(*args, dtype=torch.bfloat16,
                                    budget=ctx.budget)
        numbers = check.train_numbers(ctl, ref)
    else:
        prep = view.prepare(ctx)
        base = splat.Params(*[x.to(torch.bfloat16) for x in prep["base"]])
        img = splat.render(base, camera.cam(
            prep["poses"][1], cfg["width"], cfg["height"], ctx.device,
            torch.bfloat16), cfg["sh_degree"], torch.zeros(
                3, dtype=torch.bfloat16), ctx.budget)["image"].float()
        numbers = view.compare(ctx, prep, {0: (
            1, img, check.quantize(img).tobytes())})
    ok, checks = check.judge(numbers, cell.limits)
    assert not ok, checks
