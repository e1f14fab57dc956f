#!/usr/bin/env python3
"""Chip smoke of the PyTorch + CUDA port (``gsplat_tpu_torch``) on one GPU.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit) and build the CUDA
   kernels from ``gsplat_tpu_torch/csrc`` with nvcc for sm_90a;
2. load the 1080p serving scene ``assets/trained_scene_big.npz`` (262,046
   gaussians, SH degree 3) plus num_class=2 segment logits from
   ``numpy.random.default_rng(0)``, at bench.py's 1920x1080 camera
   (R = I, T = [0, 0.6, 4.2], FoVx 62 degrees);
3. K3 (expansion): the kernel against its plain version at the scene's real
   binning inputs — tile ids, gaussian ids and tile starts bit-equal;
4. K1 (forward composite): the kernel against its plain version on that
   binning — every channel within the JAX tests' tolerances; K1 built with
   the other ``--fmad`` setting, compared here and timed beside the main
   build after the training path; the (pixel, instance) pairs these inputs need, counted for
   K1's bound;
5. K4 (segment sum) at the training path's inputs — the asset's instance
   list sorted by gaussian id, [I, 12] rows from a seeded generator —
   against its plain version and against ``index_add_`` (timed as the
   library call); K2 (backward composite) on the asset's binning and K1's
   packed output with a seeded cotangent against its plain version, per
   column within 1e-3 of the column's maximum, every row finite, pad slots
   zero, two launches bit-equal;
6. a small scene rendered on the card against the O(P*H*W) oracle;
7. the render path: ``gsplat_tpu_torch.renderer.render`` once with the
   launch counters zeroed just before — no overflow, finite outputs, K3
   and K1 launched — then ms/frame over warmed renders, device busy time
   from a profiler window, and per-stage times, all with CUDA events;
8. the training path: the asset in a model of 524,288 slots, targets
   rendered from the unperturbed asset, parameters perturbed by seeded
   noise; ten steps of ``train.trainer.make_train_step`` (SH degree 3,
   num_class=2, segment loss, depth loss "L1_loss") with the launch counters
   zeroed just before — K3, K1, K2 and K4 once per step, no overflow,
   falling loss, finite state — then ms/step, device busy time per step,
   one ``densify_and_prune`` whose clones and splits fire, and one more
   step.

The last three lines are the kernel table as one JSON object, the card
line, and ``{"ok": true, "device": {...}}``.  Without a usable card the
script exits 2 and prints no result.
"""
import ctypes
import json
import math
import os
import subprocess
import sys
import time

# Tolerances of the JAX tests between the Pallas path and the oracle
# (tests/test_pallas_composite.py:35-43).
ATOL = {"rgb": 3e-5, "alpha": 3e-5, "segment": 3e-5, "T_final": 3e-5,
        "depth": 3e-4}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_OPS_PER_S = 67e12         # H100 SXM, published, non-tensor fp32
W, H = 1920, 1080
NUM_CLASS = 2
ASSET = os.path.join("assets", "trained_scene_big.npz")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def event_ms(torch, fn, iters, warmup=2):
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def compare_k1(comp, packed, packed_p, C):
    """K1 output against its plain version: (max |diff| over the channels
    and T_final, pixels over tolerance per channel, n_contrib mismatches)."""
    channels = {"rgb": slice(0, 3), "depth": slice(3, 4),
                "segment": slice(4, 4 + NUM_CLASS), "alpha": slice(C - 1, C)}
    img, tf = comp.unpack_tiles(packed, C, W, H)
    img_p, tf_p = comp.unpack_tiles(packed_p, C, W, H)
    err, over = 0.0, {}
    for name, sl in channels.items():
        d = (img[sl] - img_p[sl]).abs()
        err = max(err, float(d.max()))
        over[name] = int((d > ATOL[name]).any(dim=0).sum())
    d = (tf - tf_p).abs()
    err = max(err, float(d.max()))
    over["T_final"] = int((d > ATOL["T_final"]).sum())
    nc_diff = int((packed[:, C + 1] != packed_p[:, C + 1]).sum())
    return err, over, nc_diff


def build_k1_variant(_kernels, fmad):
    """K1 (with common.cu) built into a library of its own with nvcc's
    ``--fmad=<fmad>`` and the main build's other flags; returns its C
    entry."""
    flags = [f for f in _kernels.NVCC_FLAGS if not f.startswith("--fmad")]
    path = os.path.join(_kernels.BUILD_DIR, f"libk1_fmad_{fmad}.so")
    p = subprocess.run(
        [_kernels.find_nvcc(), *flags, f"--fmad={fmad}", "-shared",
         "-I", _kernels.CSRC_DIR,
         *[os.path.join(_kernels.CSRC_DIR, s)
           for s in ("common.cu", "composite_fwd.cu")], "-o", path],
        capture_output=True, text=True)
    check(p.returncode == 0, f"K1 --fmad={fmad} build failed\n{p.stdout}"
          f"{p.stderr}")
    fn = ctypes.CDLL(path).gsplat_composite_forward
    fn.argtypes = _kernels.SIGNATURES["gsplat_composite_forward"]
    fn.restype = ctypes.c_int
    return fn


# fp32 operations of K1 (csrc/composite_fwd.cu) per (pixel, instance) pair,
# exp2 counted as one: a tested pair takes dx, dy (2), power (9), the exp2
# argument, exp2, opacity product and cap (4) and the two skip tests (2); a
# pair that passes them takes test_T and its compare (3); a composited pair
# also takes alpha*T and a multiply and an add per channel (1 + 2C).
K1_TEST_OPS = 17
K1_STEP_OPS = 3


def k1_pair_counts(torch, comp, table, gauss_id, starts, counts, grid_x,
                   n_contrib):
    """(tested, composited, stopping) (pixel, instance) pairs that K1 needs
    on these inputs, given the plain version's per-pixel ``n_contrib``
    [T, TILE_PIX] (1-based position of the last composited instance).

    Before position n_contrib every instance that passes the skip tests is
    composited.  The first one that passes them after it stops the pixel;
    a pixel with none tests its whole tile."""
    dev = table.device
    P, R = table.shape
    K = comp.CHUNK
    table_p = torch.cat([table, table.new_zeros((1, R))])   # sentinel row P
    big = torch.iinfo(torch.int64).max
    ks = torch.arange(K, device=dev)
    tb = max(1, (1 << 25) // (K * comp.TILE_PIX))
    tested = composited = stopping = 0
    for t0 in range(0, starts.shape[0], tb):
        t1 = min(starts.shape[0], t0 + tb)
        px, py = comp.pixel_coords(torch.arange(t0, t1, device=dev), grid_x)
        st, cnt = starts[t0:t1].long(), counts[t0:t1].long()
        nc = n_contrib[t0:t1].long()                         # [n,PIX]
        stop = torch.full_like(nc, big)
        for c0 in range(0, int(cnt.max()), K):
            if bool(((stop < big) | (cnt[:, None] <= c0)).all()):
                break
            pos = c0 + ks                                    # [K]
            valid = pos[None] < cnt[:, None]                 # [n,K]
            idx = torch.clamp(st[:, None] + pos[None], 0,
                              gauss_id.shape[0] - 1)
            gid = torch.where(valid, gauss_id[idx].long(), P)
            gid = torch.where((gid >= 0) & (gid < P), gid, P)
            power, alpha = comp.pair_power_alpha(table_p[gid], px, py)
            passes = ((gid < P)[:, :, None] & (power <= 0.0)
                      & (alpha >= comp.ALPHA_MIN))
            before = pos[None, :, None] < nc[:, None, :]
            composited += int((passes & before).sum())
            stop = torch.minimum(stop, torch.where(
                passes & ~before, pos[None, :, None], big).amin(dim=1))
        found = stop < big
        stopping += int(found.sum())
        tested += int(torch.where(found, stop + 1, cnt[:, None]).sum())
    return tested, composited, stopping


# fp32 operations of K2 (csrc/composite_bwd.cu) per (pixel, instance) pair: a
# tested pair (every position up to the pixel's n_contrib) takes K1's 17 and
# the n_contrib gate (1); a composited pair also takes g (2C), w (1), the
# prefix (2), the suffix (1), d alpha (5), the cap test and dpow (2), the
# five moment products (5), the T update (2), the feature products (Cg) and
# one add per summed value (6 + Cg): 24 + 2C + 2Cg.
K2_TEST_OPS = 18


def k2_pair_ops(C, Cg):
    return 24 + 2 * C + 2 * Cg


def single_ms(torch, fn):
    """ms of one call of ``fn`` (CUDA events), and its result."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def profile_window(torch, fn, n, unit, median_ms, card, top=8):
    """Device busy ms per ``unit`` over ``n`` profiled calls of ``fn`` (the
    kernels' own durations), its idle share of ``median_ms`` and the largest
    device items.  Returns the busy ms, or None if the profiler saw no
    device events."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        print(f"profile ({unit}): the profiler saw no device events; device "
              "busy time not measured")
        return None

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in dev_events) / 1e3 / n
    n_kernels = sum(e.count for e in dev_events) / n
    print(f"profile [{card}]: device busy {busy_ms:.3f} ms/{unit} in "
          f"{n_kernels:.0f} device ops/{unit}; idle share "
          f"{1 - busy_ms / median_ms:.3f} of the {median_ms:.3f} ms "
          f"median {unit}")
    for e in sorted(dev_events, key=dev_us, reverse=True)[:top]:
        print(f"  {dev_us(e) / 1e3 / n:8.4f} ms/{unit} "
              f"x{e.count // n:<4d} {e.key[:90]}")
    return busy_ms


def phase_k4(torch, seg, card, gauss_id, P, R):
    """K4 at the training path's inputs: the asset's instance list sorted by
    gaussian id, [I, R] rows from a seeded generator."""
    dev = gauss_id.device
    I = gauss_id.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    vals = torch.randn((I, R), generator=gen, device=dev)
    sids, perm = torch.sort(gauss_id, stable=True)
    out_k = seg.segment_sum_sorted(vals, sids, P, perm)
    out_p = seg.segment_sum_sorted_plain(vals, sids, P, perm)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(out_k).all()), "K4: non-finite output")
    err = float((out_k - out_p).abs().max())
    n_kept = int((gauss_id < P).sum())
    longest = int(torch.bincount(sids[sids < P].long(), minlength=1).max())
    # rows are N(0,1); a segment of n rows sums to ~sqrt(n), and the two
    # versions add the same float32 values in another order
    tol = 1e-5 * max(1.0, math.sqrt(longest)) * 8
    print(f"K4 segment_sum_sorted vs plain: max |diff| {err:.3g} (tolerance "
          f"{tol:.3g}: float32 sums of up to {longest} rows in another "
          f"order), {n_kept} of {I} rows kept, {P} segments")
    check(err <= tol, "K4: kernel disagrees with its plain version")
    # the one PyTorch call that computes the same function of (rows, ids):
    # index_add_ on the unsorted ids, the pad sentinel landing in row P
    idx_long = gauss_id.clamp(0, P).long()
    lib_out = torch.empty((P + 1, R), device=dev)

    def library():
        return lib_out.zero_().index_add_(0, idx_long, vals)

    lib_err = float((library()[:P] - out_k).abs().max())
    check(lib_err <= tol, "K4: kernel disagrees with index_add_")
    ms = event_ms(torch, lambda: seg.segment_sum_sorted(vals, sids, P, perm),
                  20)
    plain_ms = event_ms(torch, lambda: seg.segment_sum_sorted_plain(
        vals, sids, P, perm), 5)
    library_ms = event_ms(torch, library, 20)
    sort_ms = event_ms(torch, lambda: torch.sort(gauss_id, stable=True), 20)
    # bytes these inputs need: each kept row once with its id and its
    # permutation entry, each output word once; one add per kept value
    nbytes = n_kept * (R * 4 + 4 + 8) + P * R * 4
    bound, by = bound_ms(nbytes, n_kept * R)
    print(f"K4 [{card}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ {library_ms:.4f} ms, the id sort before it "
          f"{sort_ms:.4f} ms; bound {bound:.4f} ms ({nbytes} bytes, "
          f"{n_kept * R} adds)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def phase_k2(torch, comp, card, k1_args, packed, P, C, tested, composited):
    """K2 on the asset's binning and K1's packed output, with a seeded
    cotangent, against its plain version."""
    table, gauss_id, starts, counts, gx = k1_args
    dev = table.device
    Cg = C - 1                      # the ones channel gets no gradient row
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    d_packed = torch.randn(packed.shape, generator=gen, device=dev)
    args = (*k1_args, packed, d_packed, Cg)
    d_k = comp.composite_backward(*args)
    torch.cuda.synchronize()
    plain_ms, d_p = single_ms(torch, lambda: comp.composite_backward_plain(
        *args))
    check(bool(torch.isfinite(d_k).all()), "K2: non-finite gradient row")
    pad_max = float(d_k[gauss_id >= P].abs().max())
    check(pad_max == 0.0, f"K2: pad slots carry gradient (max {pad_max})")
    diff = (d_k - d_p).abs().amax(dim=0)
    scale = d_p.abs().amax(dim=0)
    check(bool((scale > 0).all()), "K2: a gradient column is all zero")
    scaled = (diff / scale).tolist()
    err = float(diff.max())
    names = ["mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "opacity"
             ] + [f"feat{c}" for c in range(Cg)]
    print("K2 composite_backward vs plain, max |diff| over the column's max "
          "(tolerance 1e-3, tests/test_pallas_composite.py:96-100): "
          + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, scaled))
          + f"; max |diff| {err:.3g}; rows written "
          f"{int((d_k != 0).any(dim=1).sum())} of {d_k.shape[0]}; plain "
          f"version {plain_ms:.1f} ms")
    check(max(scaled) <= 1e-3, "K2: kernel disagrees with its plain version")
    again = comp.composite_backward(*args)
    check(torch.equal(again, d_k), "K2: two launches gave different bits")
    ms = event_ms(torch, lambda: comp.composite_backward(*args), 10)
    nbytes = (table.numel() * 4 + int(counts.sum()) * 4
              + 2 * 4 * starts.shape[0] + 2 * packed.numel() * 4
              + d_k.numel() * 4)
    nops = K2_TEST_OPS * tested + k2_pair_ops(C, Cg) * composited
    bound, by = bound_ms(nbytes, nops)
    print(f"K2 [{card}]: kernel {ms:.4f} ms (with the zero fill of its "
          f"[{d_k.shape[0]}, {d_k.shape[1]}] output); bound {bound:.4f} ms "
          f"({nbytes} bytes; {nops} ops = {K2_TEST_OPS} x {tested} pairs up "
          f"to n_contrib + {k2_pair_ops(C, Cg)} x {composited} composited)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


TRAIN_CAPACITY = 524288
TRAIN_STEPS = 10
# The reference's inverse-depth L1 turns a pixel no gaussian touches
# (depth 0) into 1e6; a third of the asset's view is such pixels, and at the
# default weight 0.1 that constant (and its jumps when a pixel's coverage
# flips) would swamp the float32 loss.  The weight is cut so the depth
# channel still gets a real cotangent and the loss stays readable.
TRAIN_LAMBDA_DEPTH = 1e-7


def phase_train(torch, np, card, cam, model, cap):
    """The training path through ``make_train_step`` at full width: the
    asset in a model of TRAIN_CAPACITY slots, targets rendered from the
    unperturbed asset, parameters perturbed by seeded noise, TRAIN_STEPS Adam
    steps, one ``densify_and_prune``, one more step.  Returns the launch
    counts of the steps and the step count."""
    from gsplat_tpu_torch import _kernels, renderer
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.models import adam, densify
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.train import schedules, trainer

    dev = model.device
    P = model.capacity
    tm = GaussianModel(3, num_class=NUM_CLASS, capacity=TRAIN_CAPACITY,
                       device=dev)
    for dst, src in zip(tm.params, model.params):
        dst[:P] = src
    tm.aux.alive[:P] = True
    tm.active_sh_degree = 3
    tm.training_setup()

    target = renderer.render(cam, tm, max_instances=cap, device=dev)
    check(not bool(target["overflow"]), "train: target render overflowed")
    batch = trainer.camera_batch(
        cam, gt_depth=target["depth_raw"][None],
        gt_seg=torch.argmax(target["segment"], dim=0), device=dev)
    batch["gt_image"] = target["render"]
    untouched = int((target["depth_raw"] <= 0).sum())

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    noise = dict(xyz=0.005, features_dc=0.05, features_rest=0.01,
                 scaling=0.05, rotation=0.02, opacity=0.2, segment=0.3)
    params = tm.params._replace(**{
        k: torch.cat([v[:P] + noise[k] * torch.randn(
            v[:P].shape, generator=gen, device=dev), v[P:]])
        for k, v in tm.params._asdict().items()})
    opt_state, aux = tm.opt_state, tm.aux

    opt = OptimizationParams()
    opt.lambda_depth = TRAIN_LAMBDA_DEPTH
    cfg = RasterizeConfig(width=W, height=H, sh_degree=3,
                          num_class=NUM_CLASS, max_instances=cap)
    step = trainer.make_train_step(cfg, opt, 3, "L1_loss", True,
                                   torch.zeros(3, device=dev), device=dev)
    lr_fn = schedules.make_lr_fn(opt, 1.0)

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    history, times = [], []
    for it in range(1, TRAIN_STEPS + 1):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        params, opt_state, aux, m = step(params, opt_state, aux, batch,
                                         lr_fn(it))
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
        history.append({k: float(v) for k, v in m.items()})
    launches = dict(_kernels.launch_counts)
    print(f"train: launches over {TRAIN_STEPS} steps {json.dumps(launches)}")
    check(all(v == TRAIN_STEPS for v in launches.values()),
          "train: K3, K1, K2 and K4 did not each launch once per step")
    for h in (history[0], history[-1]):
        print("train: step metrics " + json.dumps(h))
    check(all(math.isfinite(h["loss"]) for h in history),
          "train: non-finite loss")
    check(not any(h["overflow"] for h in history), "train: a step overflowed")
    check(history[-1]["loss"] < history[0]["loss"],
          f"train: loss did not fall ({history[0]['loss']} -> "
          f"{history[-1]['loss']})")
    check(history[-1]["l1"] < history[0]["l1"], "train: l1 did not fall")
    for name, tree in (("params", params), ("mu", opt_state.mu),
                       ("nu", opt_state.nu), ("aux", aux[1:])):
        check(all(bool(torch.isfinite(x).all()) for x in tree),
              f"train: non-finite {name}")
    check(int(opt_state.count) == TRAIN_STEPS, "train: Adam step count")
    ms_step = float(np.median(times[2:]))
    print(f"train {W}x{H} [{card}]: capacity {TRAIN_CAPACITY}, {P} alive, "
          f"{untouched} target pixels untouched, lambda_depth "
          f"{TRAIN_LAMBDA_DEPTH}; loss {history[0]['loss']:.6f} -> "
          f"{history[-1]['loss']:.6f}, l1 {history[0]['l1']:.6f} -> "
          f"{history[-1]['l1']:.6f}; median {ms_step:.3f} ms/step over "
          f"{len(times) - 2} warmed steps (p10 "
          f"{np.percentile(times[2:], 10):.3f}, p90 "
          f"{np.percentile(times[2:], 90):.3f}; first step {times[0]:.1f})")

    # the same profiler window as the frames, over 5 more steps
    state = [params, opt_state, aux]

    def one_step():
        state[0], state[1], state[2], _ = step(*state, batch,
                                               lr_fn(TRAIN_STEPS))
    profile_window(torch, one_step, 5, "step", ms_step, card, top=12)
    params, opt_state, aux = state

    # the step's three stages, timed apart on the same state: forward
    # (render and losses), backward (one autograd.grad: K2, K4, preprocess),
    # update (statistics, Adam, overflow gate)
    loss_fn = trainer.make_loss_fn(cfg, opt, 3, "L1_loss", True,
                                   torch.zeros(3, device=dev), device=dev)
    lrs = lr_fn(TRAIN_STEPS)
    lrs_tree = type(params)(**{k: lrs[k] for k in params._fields})
    stage = {"forward": [], "backward": [], "update": []}
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        leaves = type(params)(*[x.detach().requires_grad_(True)
                                for x in params])
        m2d = torch.zeros((TRAIN_CAPACITY, 2), device=dev,
                          requires_grad=True)
        ev[0].record()
        loss, auxout = loss_fn(leaves, m2d, batch)
        ev[1].record()
        grads = torch.autograd.grad(loss, [*leaves, m2d])
        ev[2].record()
        new_aux = densify.add_densification_stats(aux, grads[-1],
                                                  auxout["radii"])
        new_p, new_o = adam.update(type(params)(*grads[:-1]), opt_state,
                                   params, lrs_tree)
        trainer.gate_on_overflow(auxout["overflow"],
                                 (new_p, new_o, new_aux),
                                 (params, opt_state, aux))
        ev[3].record()
        torch.cuda.synchronize()
        for name, a, b in zip(stage, ev, ev[1:]):
            stage[name].append(a.elapsed_time(b))
    print(f"train stages [{card}] (median of 5 after one warm-up, ms): "
          + ", ".join(f"{k} {np.median(v[1:]):.3f}" for k, v in stage.items()))

    # one densification with a threshold that fires: the 90th percentile
    # of the accumulated gradient norms, and the clone/split boundary at
    # the median scale of the candidates so that both branches fire
    grads = torch.where(aux.denom > 0, aux.xyz_gradient_accum / aux.denom,
                        0.0)
    seen = aux.alive & (aux.denom > 0)
    thr = float(torch.quantile(grads[seen], 0.9))
    cand = aux.alive & (grads >= thr)
    max_scale = torch.exp(params.scaling).max(dim=1).values
    extent = float(torch.quantile(max_scale[cand], 0.5)) / opt.percent_dense
    alive_before = int(aux.alive.sum())
    params, aux, opt_state, stats = densify.densify_and_prune(
        params, aux, opt_state, thr, 0.005, extent, 20, opt.percent_dense,
        use_screen_size=False, generator=gen)
    st = {k: int(v) for k, v in stats._asdict().items()}
    print(f"densify: threshold {thr:.3g}, extent {extent:.3g}, alive before "
          f"{alive_before}, stats {json.dumps(st)}")
    check(st["n_cloned"] > 0 and st["n_split"] > 0,
          "densify: clones and splits did not both fire")
    check(st["n_dropped"] == 0, "densify: candidates dropped")
    check(st["n_alive"] == alive_before + st["n_cloned"] + st["n_split"]
          - st["n_pruned"] == int(aux.alive.sum()),
          "densify: n_alive does not follow from the stats")
    check(all(bool(torch.isfinite(x).all()) for x in params),
          "densify: non-finite parameter")
    params, opt_state, aux, m = step(params, opt_state, aux, batch,
                                     lr_fn(TRAIN_STEPS + 1))
    check(math.isfinite(float(m["loss"])) and not bool(m["overflow"]),
          "train: the step after densification failed")
    print(f"train: step after densification: loss {float(m['loss']):.6f}, "
          f"num_rendered {int(m['num_rendered'])}, n_visible "
          f"{int(m['n_visible'])}")
    return launches, TRAIN_STEPS


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.core.cameras import Camera
    from gsplat_tpu_torch.models.gaussians import GaussianModel, params_from_numpy
    from gsplat_tpu_torch.ops import binning as bin_lib
    from gsplat_tpu_torch.ops import composite_cuda as comp
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    from gsplat_tpu_torch.ops import segment_reduce as seg_lib
    from gsplat_tpu_torch.ops.composite_ref import composite_reference

    # plain versions use no matmul, but state the fp32 modes all the same
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    report = _kernels.build()
    _kernels.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, "
          f"{len(_kernels.SOURCES)} sources in parallel)")
    for line in report.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            print("  ptxas:", line.strip())

    # ---- 2. scene ---------------------------------------------------------
    model = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device=dev)
    model.load_npz(ASSET)
    P = model.capacity
    seg = np.random.default_rng(0).standard_normal((P, NUM_CLASS))
    model.params = model.params._replace(
        segment=torch.from_numpy(seg.astype(np.float32)).to(dev))
    fovx = math.radians(62.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.6, 4.2]),
                 FoVx=fovx, FoVy=fovy, image=np.zeros((3, H, W), np.float32),
                 image_name="bench", uid=0)
    gx = (W + pre_lib.TILE_X - 1) // pre_lib.TILE_X
    gy = (H + pre_lib.TILE_Y - 1) // pre_lib.TILE_Y
    num_tiles = gx * gy
    cap = renderer._auto_capacity(cam, model, W, H, 1.0)
    p = model.params
    mats = [torch.as_tensor(m, device=dev) for m in (
        cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    pre_args = (p.xyz, T.scaling_activation(p.scaling), p.rotation,
                T.opacity_activation(p.opacity[:, 0]), model.get_features, 3,
                *mats, cam.tan_fovx, cam.tan_fovy, W, H)
    pre = pre_lib.preprocess(*pre_args)
    print(f"scene: {P} gaussians, {W}x{H}, tile {pre_lib.TILE_X}x"
          f"{pre_lib.TILE_Y} ({num_tiles} tiles), capacity {cap}, "
          f"visible {int(pre.visible.sum())}")

    # ---- 3. K3 against its plain version ----------------------------------
    src = bin_lib.expansion_sources(pre, gx, gy, 128)
    S = src.offsets.shape[0]
    k3_args = (src.offsets, src.meta, src.gid, cap, src.rw_bits, gx,
               num_tiles)
    tile_k, gid_k = bin_lib.expand(*k3_args)
    tile_p, gid_p = bin_lib.expand_plain(*k3_args)
    k3_err = max(int((tile_k - tile_p).abs().max()),
                 int((gid_k - gid_p).abs().max()))
    k3_bad = int((tile_k != tile_p).sum() + (gid_k != gid_p).sum())
    bins = bin_lib.bin_gaussians(pre, gx, gy, cap)
    order_p = torch.sort(tile_p, stable=True)[1]
    for f, want in (("tile_id", tile_p[order_p]), ("gauss_id", gid_p[order_p]),
                    ("tile_start", src.tile_start)):
        check(torch.equal(getattr(bins, f), want),
              f"K3: binning {f} differs from the plain version")
    check(k3_bad == 0, f"K3: {k3_bad} slots differ from the plain version")
    check(not bool(bins.overflow), "K3: capacity overflow at 1080p")
    print(f"K3 expand: bit-equal to its plain version on {cap} slots "
          f"({S} sources, {int(bins.num_rendered)} instances, "
          f"{int(bins.num_padded)} padded)")

    # ---- 4. K1 against its plain version ----------------------------------
    feats = torch.cat([pre.rgb, pre.depths[:, None],
                       T.segment_activation(p.segment),
                       torch.ones_like(pre.depths[:, None])], dim=1)
    C = feats.shape[1]
    table = torch.cat([pre.means2d, pre.conic, pre.opacity[:, None], feats],
                      dim=1).contiguous()
    starts, counts = comp.tile_ranges(bins)
    gid_sorted = bins.gauss_id
    k1_args = (table, gid_sorted, starts, counts, gx)
    packed_k = comp.composite_forward(*k1_args)
    t0 = time.perf_counter()
    packed_p = comp.composite_forward_plain(*k1_args)
    torch.cuda.synchronize()
    print(f"K1 plain version at {W}x{H}: {time.perf_counter() - t0:.1f} s")
    img_k = comp.unpack_tiles(packed_k, C, W, H)[0]
    k1_err, over, nc_diff = compare_k1(comp, packed_k, packed_p, C)
    print(f"K1 composite_forward vs plain: max |diff| {k1_err:.3g}; pixels "
          f"over tolerance {json.dumps(over)}; n_contrib differs at "
          f"{nc_diff} pixels")
    check(sum(over.values()) == 0 and nc_diff == 0,
          "K1: kernel disagrees with its plain version")
    check(bool(torch.isfinite(packed_k).all()), "K1: non-finite output")

    # K1 built with the other --fmad setting: what the main build's choice
    # costs or saves, and how far the other build strays from the plain
    # version (a flipped termination moves a pixel by up to alpha*T*feat)
    alt_fmad = "true" if "--fmad=false" in _kernels.NVCC_FLAGS else "false"
    k1_alt_fn = build_k1_variant(_kernels, alt_fmad)

    def k1_alt():
        o = torch.empty_like(packed_k)
        err = k1_alt_fn(table.data_ptr(), table.shape[0], C,
                        gid_sorted.data_ptr(), starts.data_ptr(),
                        counts.data_ptr(), num_tiles, gx, pre_lib.TILE_X,
                        pre_lib.TILE_Y, o.data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"K1 --fmad={alt_fmad} build: CUDA error {err}")
        return o

    alt_err, alt_over, alt_nc = compare_k1(comp, k1_alt(), packed_p, C)
    print(f"K1 built with --fmad={alt_fmad} vs plain: max |diff| "
          f"{alt_err:.3g}; pixels over tolerance {json.dumps(alt_over)}; "
          f"n_contrib differs at {alt_nc} pixels")

    # the (pixel, instance) pairs these inputs need, from the plain version
    t0 = time.perf_counter()
    tested, contributing, stopping = k1_pair_counts(
        torch, comp, table, gid_sorted, starts, counts, gx,
        packed_p[:, C + 1])
    print(f"K1 pairs: {tested} tested, {contributing} composited, "
          f"{stopping} stopping ({time.perf_counter() - t0:.1f} s to count)")

    # ---- 5. K4 and K2 against their plain versions -------------------------
    k4 = phase_k4(torch, seg_lib, card, gid_sorted, P, comp.ATTR_BASE + C - 1)
    k2 = phase_k2(torch, comp, card, k1_args, packed_k, P, C,
                  int(packed_p[:, C + 1].sum()), contributing)

    # ---- 6. a small scene against the oracle ------------------------------
    rng = np.random.default_rng(1)
    ns = 300
    small = params_from_numpy(dict(
        xyz=rng.standard_normal((ns, 3)) * 1.2,
        features_dc=rng.standard_normal((ns, 1, 3)) * 0.8,
        features_rest=rng.standard_normal((ns, 15, 3)) * 0.2,
        scaling=rng.standard_normal((ns, 3)) * 0.5 - 2.5,
        rotation=rng.standard_normal((ns, 4)),
        opacity=rng.standard_normal((ns, 1)) * 1.5,
        segment=rng.standard_normal((ns, NUM_CLASS))), device=dev)
    scam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                  FoVx=math.radians(60.0), FoVy=math.radians(60.0),
                  image=np.zeros((3, 64, 64), np.float32), image_name="s",
                  uid=0)
    sout = renderer.render(scam, small, max_instances=1 << 14, device=dev)
    sp = small.params
    spre = pre_lib.preprocess(
        sp.xyz, T.scaling_activation(sp.scaling), sp.rotation,
        T.opacity_activation(sp.opacity[:, 0]), small.get_features, 3,
        *[torch.as_tensor(m, device=dev) for m in (
            scam.world_view_transform, scam.full_proj_transform,
            scam.camera_center)], scam.tan_fovx, scam.tan_fovy, 64, 64)
    ref = composite_reference(spre, 64, 64, torch.zeros(3, device=dev),
                              segments=T.segment_activation(sp.segment))
    for k, tol in (("render", ATOL["rgb"]), ("alpha", ATOL["alpha"]),
                   ("segment", ATOL["segment"])):
        err = float((sout[k] - ref[k]).abs().max())
        check(err <= tol, f"small scene: {k} differs from the oracle by {err}")
    err = float((sout["depth_raw"] - ref["depth"]).abs().max())
    check(err <= ATOL["depth"], f"small scene: depth differs by {err}")
    print("small scene (64x64, 300 gaussians): card render within tolerance "
          "of the oracle")

    # ---- 7. the render path -----------------------------------------------
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = renderer.render(cam, model, device=dev)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    print(f"render: launches {json.dumps(launches)}")
    check(launches["expand"] == 1 and launches["composite_forward"] == 1,
          "render did not launch K3 and K1 once each")
    check(not bool(out["overflow"]), "render overflowed its capacity")
    check(out["render"].shape == (3, H, W) and out["alpha"].shape == (H, W)
          and out["segment"].shape == (NUM_CLASS, H, W), "output shapes")
    for k in ("render", "depth", "alpha", "segment"):
        check(bool(torch.isfinite(out[k]).all()), f"render: non-finite {k}")
    check(float(out["alpha"].min()) >= -1e-6
          and float(out["alpha"].max()) <= 1 + 1e-6, "alpha outside [0, 1]")
    check(torch.equal(out["render"], img_k[0:3]), "render differs from K1 "
          "phase image on the same inputs")
    num_rendered = int(out["num_rendered"])
    print(f"render: num_rendered {num_rendered}, overflow False, "
          f"mean rgb {float(out['render'].mean()):.4f}, "
          f"mean alpha {float(out['alpha'].mean()):.4f}")

    # frame time: CUDA events around each warmed render
    for _ in range(3):
        renderer.render(cam, model, device=dev)
    torch.cuda.synchronize()
    times = []
    for _ in range(30):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        renderer.render(cam, model, device=dev)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    ms_frame = float(np.median(times))
    print(f"render {W}x{H} [{card}]: median {ms_frame:.3f} ms/frame, "
          f"{1e3 / ms_frame:.2f} fps over {len(times)} renders "
          f"(p10 {np.percentile(times, 10):.3f}, "
          f"p90 {np.percentile(times, 90):.3f})")

    # device busy time per frame from a profiled window of renders: the
    # kernels' own durations, against the frame time above (idle share)
    profile_window(torch, lambda: renderer.render(cam, model, device=dev),
                   10, "frame", ms_frame, card)

    # ---- 8. the training path ---------------------------------------------
    train_launches, train_steps = phase_train(torch, np, card, cam, model,
                                              cap)

    # per-stage times on the main path's own inputs
    tile_k, gid_k = bin_lib.expand(*k3_args)
    stages = {
        "preprocess": lambda: pre_lib.preprocess(*pre_args),
        "binning incl. K3 (before the sort)": lambda: bin_lib.expand(
            *bin_lib.expansion_sources(pre, gx, gy, 128)[:3], cap,
            src.rw_bits, gx, num_tiles),
        "stable tile sort": lambda: gid_k[torch.sort(tile_k, stable=True)[1]],
        "composite (table, ranges, K1, unpack)": lambda: comp.composite_cuda(
            pre.means2d, pre.conic, pre.opacity, feats, bins, W, H),
        "K3 kernel alone": lambda: bin_lib.expand(*k3_args),
        "K1 kernel alone": lambda: comp.composite_forward(*k1_args),
    }
    stage_ms = {}
    for name, fn in stages.items():
        stage_ms[name] = event_ms(torch, fn, 20)
        print(f"stage [{card}] {name}: {stage_ms[name]:.4f} ms")
    # main and other --fmad build of K1, alternated in this one run
    main_fmad = "false" if alt_fmad == "true" else "true"
    fmad_ms = {main_fmad: [stage_ms["K1 kernel alone"]], alt_fmad: []}
    for _ in range(2):
        fmad_ms[alt_fmad].append(event_ms(torch, k1_alt, 20))
        fmad_ms[main_fmad].append(event_ms(
            torch, lambda: comp.composite_forward(*k1_args), 20))
    print(f"K1 [{card}] --fmad={main_fmad} (main build): "
          f"{', '.join(f'{t:.4f}' for t in fmad_ms[main_fmad])} ms; "
          f"--fmad={alt_fmad}: "
          f"{', '.join(f'{t:.4f}' for t in fmad_ms[alt_fmad])} ms")
    k3_plain_ms = event_ms(torch, lambda: bin_lib.expand_plain(*k3_args), 10)
    k1_plain_ms = event_ms(torch, lambda: comp.composite_forward_plain(
        *k1_args), 2, warmup=1)
    print(f"plain [{card}] K3 expand_plain: {k3_plain_ms:.4f} ms; "
          f"K1 composite_forward_plain: {k1_plain_ms:.2f} ms")
    print("clocks/power after timing: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip())

    # bounds: each input read once, each output written once
    k3_bytes = 3 * 4 * S + 2 * 4 * cap
    k3_ops = cap * (4 * math.ceil(math.log2(S + 1)) + 12)
    k3_bound, k3_by = bound_ms(k3_bytes, k3_ops)
    k1_bytes = (table.numel() * 4 + int(counts.sum()) * 4 + 2 * 4 * num_tiles
                + packed_k.numel() * 4)
    k1_ops = (K1_TEST_OPS * tested + K1_STEP_OPS * (contributing + stopping)
              + (1 + 2 * C) * contributing)
    k1_bound, k1_by = bound_ms(k1_bytes, k1_ops)
    print(f"K3 bound: {k3_bytes} bytes, {k3_ops} ops; K1 bound: {k1_bytes} "
          f"bytes, {k1_ops} ops ({K1_TEST_OPS} per tested pair, "
          f"{K1_STEP_OPS} more per composited or stopping pair, {1 + 2 * C} "
          "more per composited pair)")
    kernels = [
        {"name": "K3 expand", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/expand.cu",
         "replaces": "gsplat_tpu/ops/binning.py:84",
         "launches": launches["expand"], "max_abs_err": float(k3_err),
         "ms": stage_ms["K3 kernel alone"], "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "K1 composite_forward", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "gsplat_tpu/ops/composite_pallas.py:247",
         "launches": launches["composite_forward"],
         "max_abs_err": k1_err, "ms": stage_ms["K1 kernel alone"],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "K2 composite_backward", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/composite_bwd.cu",
         "replaces": "gsplat_tpu/ops/composite_pallas.py:356",
         "launches": train_launches["composite_backward"], **k2},
        {"name": "K4 segment_sum_sorted", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/segsum.cu",
         "replaces": "gsplat_tpu/ops/segment_reduce.py:38",
         "launches": train_launches["segment_sum"], **k4},
    ]
    print(f"launches: K3 and K1 from the one render, K2 and K4 from the "
          f"{train_steps} training steps (K3 and K1 also ran "
          f"{train_launches['expand']} and "
          f"{train_launches['composite_forward']} times there)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
