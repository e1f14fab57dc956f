"""Traffic of kind ``train``: the port's ``Trainer.train`` driven in chunks
of ``chunk`` iterations from ``first_iter`` on, over views fixed by the mix,
with targets the reference rendered from the unperturbed scene and the
starting point perturbed by the seed.

Set-up builds the one ``Trainer`` the window drives and runs its first
three iterations through the same call; the comparison holds their losses,
the first gradient as Adam holds it after one step and the parameters'
change after three against the reference's three steps from the same
starting point, views and learning rates."""
from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from splatbench.counts import work
from splatbench.harness import cache, check, scene
from splatbench.harness.spec import ROOT
from splatbench.harness.trace import analyse, profiled
from splatbench.reference import camera, splat

B1 = 0.9   # Adam's first-moment decay (torch.optim.Adam's and 3DGS's)
FIRST_STEPS = 3


def expon_lr(step, init, final, max_steps):
    """3DGS's get_expon_lr_func without a delay phase (the training CLI's
    position schedule)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return float(math.exp(math.log(init) * (1 - t) + math.log(final) * t))


def learning_rates(opt: dict, step: int) -> dict:
    """Each field's learning rate at ``step`` (3DGS's table, spatial scale
    1)."""
    return dict(
        xyz=expon_lr(step, opt["position_lr_init"], opt["position_lr_final"],
                     opt["position_lr_max_steps"]),
        features_dc=opt["feature_lr"], features_rest=opt["feature_lr"] / 20.0,
        opacity=opt["opacity_lr"], segment=opt["segment_lr"],
        scaling=opt["scaling_lr"], rotation=opt["rotation_lr"])


def targets(config: dict, traffic: dict, base: splat.Params, views: list,
            device, budget: int) -> dict:
    """Each view's rgb (clipped to [0, 1]), raw depth and segment labels
    rendered by the reference from ``base``, and the pairs it needs;
    cached."""
    d = cache.folder(config, traffic)
    arrays = cache.load_arrays(d, "targets")
    counts = cache.load_json(d, "counts").get("views")
    if arrays is not None and counts is not None:
        return dict(arrays, counts=counts)
    W, H = config["width"], config["height"]
    bg = torch.tensor(traffic["bg"], dtype=torch.float32, device=device)
    out = {"image": [], "depth": [], "segment": []}
    counts = []
    for v in views:
        c = {}
        r = splat.render(base, camera.cam(v, W, H, device),
                         config["sh_degree"], bg, budget, counts=c)
        out["image"].append(r["image"].clamp(0, 1).cpu().numpy())
        out["depth"].append(r["depth"].cpu().numpy())
        out["segment"].append(torch.argmax(r["segment"], 0).to(
            torch.uint8).cpu().numpy())
        counts.append(c)
    arrays = {k: np.stack(v) for k, v in out.items()}
    cache.save_arrays(d, "targets", arrays)
    cache.save_json(d, "counts", {"views": counts})
    return dict(arrays, counts=counts)


class HostScene:
    """What ``Trainer`` reads of a scene: the training cameras."""

    def __init__(self, model, cams):
        self.gaussians = model
        self.cams = cams
        self.cameras_extent = 1.0

    def getTrainCameras(self):
        return self.cams

    def getTestCameras(self):
        return []


def first_steps(tr, model, p0: splat.Params, first: int) -> dict:
    """The Trainer's first three iterations, through ``train`` as the
    window calls it: each iteration's loss and view, the first gradient
    worked out from Adam's moments after one step (they start at zero), and
    the parameters' change after three."""
    n = p0.xyz.shape[0]
    views, losses, out = [], [], {}
    get = tr._get_batch

    def spy(cams, i):
        views.append(i)
        return get(cams, i)

    def record(it, metrics, trainer):
        losses.append(float(metrics["loss"]))
        if it == first + 1:
            out["grad_rows"] = [m[:n] / (1 - B1) for m in model.opt_state.mu]
            out["grad"] = check.leaf_norms(out["grad_rows"])
        if it == first + FIRST_STEPS:
            out["change"] = check.leaf_norms(
                [a[:n] - b for a, b in zip(model.params, p0)])

    tr._get_batch = spy
    try:
        tr.train(first + FIRST_STEPS, first_iter=first, log_every=1,
                 callback=record)
    finally:
        del tr._get_batch
    return dict(losses=losses, views=views, **out)


def reference_steps(p0, views, picked, tg, config, traffic, device,
                    dtype=torch.float32, rows=slice(None),
                    budget=splat.BUDGET) -> dict:
    """The reference's first three steps from ``p0`` on the views the
    program took, computed in ``dtype`` with the configuration's numerics;
    ``rows`` keeps the loss to those image rows (a fault of the
    comparison's own test)."""
    W, H = config["width"], config["height"]
    opt = traffic["optimization"]
    p = splat.Params(*[x.to(dtype) for x in p0])
    m = splat.zero_moments(p)
    bg = torch.tensor(traffic["bg"], dtype=dtype, device=device)
    out = {"losses": []}
    for k, i in enumerate(picked[:FIRST_STEPS]):
        target = dict(
            image=torch.as_tensor(tg["image"][i], device=device).to(dtype),
            depth=torch.as_tensor(tg["depth"][i], device=device).to(dtype),
            segment=torch.as_tensor(tg["segment"][i], device=device))
        loss, grads, p, m = splat.train_step(
            p, m, learning_rates(opt, traffic["first_iter"] + 1 + k),
            camera.cam(views[i], W, H, device, dtype), target, opt,
            config["sh_degree"], bg, budget, rows, config["numerics"])
        out["losses"].append(loss)
        if k == 0:
            out["grad_rows"] = list(grads)
            out["grad"] = check.leaf_norms(grads)
    out["change"] = check.leaf_norms([a.float() - b for a, b in zip(p, p0)])
    return out


def step_work(config: dict, tg: dict, p0: splat.Params) -> dict:
    W, H, S = config["width"], config["height"], config["num_class"]
    C = 4 + S + 1                     # rgb, depth, segments, weight
    tiles = -(-W // config["tile"]) * -(-H // config["tile"])
    entries = sum(x[0].numel() for x in p0)
    return work.step_work(work.mean_counts(tg["counts"]), p0.xyz.shape[0],
                          entries, C, C - 1, W, H, tiles)


def prepare(ctx) -> dict:
    """What every seed of the cell shares: the scene, the views and their
    targets."""
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    base = scene.load(cfg, ROOT, ctx.device)
    views = camera.poses(mix["views"], cfg["width"], cfg["height"])
    return dict(base=base, views=views,
                tg=targets(cfg, mix, base, views, ctx.device, ctx.budget))


def start(ctx, prep: dict, seed: int) -> dict:
    """The one Trainer of a run, from the scene perturbed by ``seed``,
    through its first three iterations (``first_steps``); ``chunks(n)``
    drives it on by ``n`` chunks."""
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.train.trainer import Trainer
    cfg, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    tg = prep["tg"]
    p0 = scene.perturb(prep["base"], mix["noise"], seed)
    model = scene.port_model(p0, cfg, cfg["train_slots"], dev, train=True)
    cams = [scene.port_camera(v, cfg, tg["image"][i], tg["depth"][i][None],
                              tg["segment"][i], uid=i)
            for i, v in enumerate(prep["views"])]
    opt = OptimizationParams()
    for k, v in mix["optimization"].items():
        setattr(opt, k, v)
    num = cfg["numerics"]
    tr = Trainer(model, HostScene(model, cams), opt,
                 depth_loss_choice=mix["depth_loss"], use_seg=True,
                 seed=seed, grad_precision=num["grad_precision"],
                 feat_precision=num["feat_precision"], cull=num["cull"],
                 bg=np.asarray(mix["bg"], np.float32))
    first, ch = mix["first_iter"], mix["chunk"]
    prog = first_steps(tr, model, p0, first)
    it = [first + FIRST_STEPS]

    def chunks(n):
        for _ in range(n):
            tr.train(it[0] + ch, first_iter=it[0], log_every=ch)
            it[0] += ch

    return dict(tr=tr, p0=p0, prog=prog, chunks=chunks)


def compare(ctx, prep: dict, run: dict) -> dict:
    """The comparison's numbers of a run (``start``'s dict) against the
    reference's steps."""
    ref = reference_steps(run["p0"], prep["views"], run["prog"]["views"],
                          prep["tg"], ctx.cell.config, ctx.cell.traffic,
                          ctx.device, budget=ctx.budget)
    return check.train_numbers(run["prog"], ref)


def run(ctx) -> dict:
    mix = ctx.cell.traffic
    prep = prepare(ctx)
    ctx.reset_peak()
    r = start(ctx, prep, ctx.seed)
    chunks, ch = r["chunks"], mix["chunk"]
    chunks(mix["warm_chunks"])
    ctx.sync()
    res = dict(setup_s=time.perf_counter() - ctx.t_start)
    if ctx.trace:
        n = mix["trace_chunks"]
        _, events, window = profiled(lambda: chunks(1), lambda: chunks(n),
                                   ctx, host=False)
        rec = analyse(events)
        _, named, _ = profiled(lambda: chunks(1), lambda: chunks(1), ctx,
                               host=True)
        rec["breakdown"]["idle_gaps"] = analyse(named)["breakdown"][
            "idle_gaps"]
        rec.update(units=n * ch, window_s=window, spans={},
                   config=ctx.cell.config,
                   counts=work.mean_counts(prep["tg"]["counts"]),
                   work=step_work(ctx.cell.config, prep["tg"], r["p0"]))
        res.update(records=rec, attempted=n * ch)
    else:
        steps, t0 = 0, time.perf_counter()
        while True:
            chunks(1)
            steps += ch
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window = time.perf_counter() - t0
        res.update(e2e=dict(train_step_ms=window / steps * 1e3,
                            setup_s=res["setup_s"]), attempted=steps)
    res.update(failed=0, peak=ctx.peak())
    del r["tr"], r["chunks"]
    ctx.free()
    res["numbers"] = compare(ctx, prep, r)
    return res
