"""Traffic of kind ``view``: one viewer in a closed loop.  Each frame is
``renderer.render(camera, model)`` and then ``network_gui.frame_bytes`` of
its image, the bytes the live viewer sends; the next camera is issued when
those bytes are in hand.  The cameras are the mix's fixed poses, visited in
a seeded order, a new permutation each round, so every seed does the same
work in another order.

The comparison takes the frames drawn from the seed among the first
``sample_range`` and the last frame of the window, and holds each one's
float image and bytes against the reference's render of its camera."""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from splatbench.counts import work
from splatbench.harness import cache, check, scene
from splatbench.harness.spec import ROOT
from splatbench.harness.trace import Spans, analyse, profiled
from splatbench.reference import camera, splat


class Order:
    """Frame i's pose: rounds of seeded permutations of the poses."""

    def __init__(self, n_poses: int, seed: int):
        self.rng = np.random.default_rng(seed)
        self.n = n_poses
        self.seq = []

    def __getitem__(self, i: int) -> int:
        while len(self.seq) <= i:
            self.seq.extend(self.rng.permutation(self.n).tolist())
        return self.seq[i]


def pose_counts(config, traffic, base, poses, wanted, device, budget,
                renders=None) -> dict:
    """The reference's pair counts of each pose in ``wanted`` (cached by
    pose), from ``renders`` (pose -> counts) where it already rendered the
    pose."""
    d = cache.folder(config, traffic)
    got = cache.load_json(d, "counts")
    W, H = config["width"], config["height"]
    bg = torch.zeros(3, device=device)
    for i in sorted(set(wanted)):
        if str(i) in got:
            continue
        if renders and i in renders:
            got[str(i)] = renders[i]
            continue
        c = {}
        splat.render(base, camera.cam(poses[i], W, H, device),
                     config["sh_degree"], bg, budget, counts=c)
        got[str(i)] = c
    cache.save_json(d, "counts", got)
    return got


def prepare(ctx) -> dict:
    """The scene, the poses, the port's model and cameras; every pose
    rendered once, pose 0 first (the renderer sizes its instance capacity
    on the first frame of a shape).  ``warm`` holds those frames' overflow
    flags."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.viz import network_gui
    cfg, mix, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    base = scene.load(cfg, ROOT, dev)
    poses = camera.poses(mix["poses"], cfg["width"], cfg["height"])
    ctx.reset_peak()
    model = scene.port_model(base, cfg, base.xyz.shape[0], dev, train=False)
    cams = [scene.port_camera(p, cfg) for p in poses]
    warm = []
    for c in cams:
        out = renderer.render(c, model, device=dev)
        network_gui.frame_bytes(out["render"])
        warm.append(out["overflow"])
    return dict(base=base, poses=poses, model=model, cams=cams, warm=warm)


def frames(ctx, prep: dict, seed: int, count: int = None,
           seconds: float = None, spans: Spans = None) -> dict:
    """The viewer's loop for ``count`` frames or ``seconds``: each frame's
    latency and overflow flag, and the frames drawn from ``seed`` among the
    first ``sample_range`` with the last one, as (pose, image, bytes)."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.viz import network_gui
    mix, dev = ctx.cell.traffic, ctx.device
    model, cams = prep["model"], prep["cams"]
    samples = set(np.random.default_rng(seed).choice(
        mix["sample_range"], mix["samples"], replace=False).tolist())
    seq = Order(len(cams), seed + 1)
    kept, flags, lat = {}, [], []
    done, t0 = 0, time.perf_counter()
    while True:
        ts = time.perf_counter()
        cam = cams[seq[done]]
        if spans is not None:
            with spans("render", sync=True):
                out = renderer.render(cam, model, device=dev)
            with spans("frame_bytes"):
                b = network_gui.frame_bytes(out["render"])
        else:
            out = renderer.render(cam, model, device=dev)
            b = network_gui.frame_bytes(out["render"])
        lat.append(time.perf_counter() - ts)
        flags.append(out["overflow"])
        if done in samples:
            kept[done] = (seq[done], out["render"], b)
        done += 1
        if (done >= count if count is not None
                else time.perf_counter() - t0 >= seconds):
            break
    window = time.perf_counter() - t0
    kept[done - 1] = (seq[done - 1], out["render"], b)
    return dict(done=done, window=window, lat=lat, kept=kept,
                failed=int(torch.stack(flags).sum()),
                poses=[seq[i] for i in range(done)])


def compare(ctx, prep: dict, kept: dict, dtype=torch.float32,
            counts: dict = None) -> dict:
    """The worst numbers of the kept frames against the reference's render
    of their poses in ``dtype``; ``counts`` (pose -> counts) gains the
    pairs of each pose rendered."""
    cfg, dev = ctx.cell.config, ctx.device
    W, H = cfg["width"], cfg["height"]
    base = splat.Params(*[x.to(dtype) for x in prep["base"]])
    bg = torch.zeros(3, device=dev, dtype=dtype)
    rows = []
    for i, (pose, image, b) in sorted(kept.items()):
        c = {}
        ref = splat.render(base, camera.cam(prep["poses"][pose], W, H, dev,
                                            dtype),
                           cfg["sh_degree"], bg, ctx.budget, counts=c)
        if counts is not None:
            counts[pose] = c
        rows.append(check.frame_numbers(image, np.frombuffer(b, np.uint8),
                                        ref["image"].float()))
    return check.worst(rows)


def run(ctx) -> dict:
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    prep = prepare(ctx)
    ctx.sync()
    res = dict(setup_s=time.perf_counter() - ctx.t_start)
    if ctx.trace:
        spans = Spans(ctx.sync)

        def warm():
            frames(ctx, prep, ctx.seed, count=8, spans=Spans(ctx.sync))
        f, events, _ = profiled(warm, lambda: frames(
            ctx, prep, ctx.seed, count=mix["trace_frames"], spans=spans),
            ctx, host=False)
        rec = analyse(events)
        _, named, _ = profiled(warm, warm, ctx, host=True)
        rec["breakdown"]["idle_gaps"] = analyse(named)["breakdown"][
            "idle_gaps"]
        rec.update(units=f["done"], window_s=f["window"],
                   spans=dict(spans.seconds))
    else:
        f = frames(ctx, prep, ctx.seed, seconds=ctx.seconds)
        res["e2e"] = dict(
            frames_per_s=f["done"] / f["window"],
            frame_ms_p95=float(np.percentile(f["lat"], 95)) * 1e3,
            setup_s=res["setup_s"])
    failed = f["failed"] + int(torch.stack(prep["warm"]).sum())
    res.update(attempted=f["done"], failed=failed, peak=ctx.peak())
    del prep["model"], prep["cams"]
    ctx.free()
    renders = {}
    res["numbers"] = compare(ctx, prep, f["kept"], counts=renders)
    if ctx.trace:
        W, H = cfg["width"], cfg["height"]
        counts = pose_counts(cfg, mix, prep["base"], prep["poses"],
                             f["poses"], ctx.device, ctx.budget, renders)
        C = 4 + cfg["num_class"] + 1
        tiles = -(-W // cfg["tile"]) * -(-H // cfg["tile"])
        per = [work.frame_work(counts[str(p)], C, W, H, tiles)
               for p in f["poses"]]
        rec["work"] = dict(
            k1={k: sum(w["k1"][k] for w in per) / len(per)
                for k in per[0]["k1"]},
            ops=sum(w["ops"] for w in per) / len(per))
        rec.update(config=cfg, counts=work.mean_counts(
            [counts[str(p)] for p in f["poses"]]))
        res["records"] = rec
    return res
