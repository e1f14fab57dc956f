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
   (R = I, T = [0, 0.6, 4.2], FoVx 62 degrees), and build K1's and K2's
   inputs through ``gsplat_tpu_torch.tools.workload.asset_workload``;
3. K3 (expansion): the kernel against its plain version at the scene's real
   binning inputs — tile ids, gaussian ids and tile starts bit-equal; (a)
   its extras form K3x at the scene's real exact-cull stage-A sources — rows,
   gaussian ids and 8 extras bit-equal — and exact-cull ``bin_gaussians``
   bit-equal field by field to the same function on the plain versions;
   both forms bit-equal to the plain version on hand-built sources at the
   asset's capacity (``tools/workload.py::k3_full_sources``: a run of
   200,000 empty sources, a 300,000-slot source, offsets reaching 1.2 I);
   K3 and K3x timed on the device alone (``tools/timing.py::median_ms``)
   beside the back-to-back mean (``event_ms``), their CTAs per SM and
   ptxas registers and spills printed after the build;
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
7. the render path: ``gsplat_tpu_torch.renderer.render`` once after the
   shape's capacity count, with the launch counters zeroed just before —
   no overflow, finite outputs, K5, K3 and K1 launched once each — then ms/frame over warmed renders, device busy time
   from a profiler window, and per-stage times, all with CUDA events;
   Then (b): ``rasterize`` with ``cull="exact"`` against ``cull="none"``
   at the asset, images within rtol 1e-5 / atol 1e-6 (1e-5 depth) and the
   gradients of one loss within rtol 3e-3 / atol 1e-3;
8. the training path: the asset in a model of 524,288 slots, targets
   rendered from the unperturbed asset, parameters perturbed by seeded
   noise; ten steps of ``train.trainer.make_train_step`` (SH degree 3,
   num_class=2, segment loss, depth loss "L1_loss") with the launch counters
   zeroed just before — K5, K6, K7, K8, K3, K1, K2 and K4 once per step, no
   overflow,
   falling loss, finite state — then ms/step, device busy time per step,
   the step with ``cull="exact"`` and without alternated from one state
   (ms/step, device busy, launches per step), one ``densify_and_prune``
   whose clones and splits fire, and one more step;
9. (c) ``train.trainer.Trainer`` at 1080p with exact cull and the JAX
   Trainer's numerics (its defaults: bf16 gradient rows, packed bf16
   features, the quad power): the perturbed
   asset in 524,288 slots on four cameras near bench.py's, 40 iterations
   with the counters zeroed just before — K3x, K3, K1 and K2 in their
   packed quad form, K4, K7 and K8 once per step, densification fires,
   an overflow only with a regrow after it, the loss falls before the first densification, the PLY, ``eval_log.jsonl``
   and a checkpoint that restores to equal tensors; (d) the command line
   ``scripts.train.main`` in process with ``--cull exact`` (and the
   same default numerics) on a small
   NeRFstudio scene written with the port — its files written and K3x
   launched (its model is kept for (h));
10. (e) the kernel probes of ``gsplat_tpu_torch.tools``: P1 and P2
   ``base`` bit-equal to K1 and K2 at the asset, every variant of P1 to P4
   against its plain version on every 17th tile (and P4 on a seeded
   block), then the six entry modules ``bench_*.main`` with the launch
   counts zeroed just before — each of P1 to P4 launched — which time
   every variant and print its share of the base variant and its bound;
11. (f) the JAX trainer's default numerics: K1 and K2 in each of their
   forms (``mxu_power``; the packed bf16 features, with K2's bf16 pair
   gradient rows; both) against their plain versions at the asset — K1
   within the tolerances of 4., n_contrib equal, the packed forms' T_final
   and n_contrib bit-equal to the f32 form's; K2 within 1e-3 of each
   column's largest, packed words within one bf16 ulp beyond it — and
   timed; then ten ``make_train_step`` steps in the JAX Trainer's
   configuration with the counters zeroed just before (K3, K1 and K2 in
   the packed quad form, K4, K7 and K8, once per step; finite state,
   falling loss),
   that step and the f32 one alternated from one state (f32, default,
   default, f32: ms/step, device busy, idle share), one counted step in
   each single form, and bench.py's serving configuration
   (``render_only=True, feat_precision="bf16"``) at 1080p: its frame
   median and device busy time;
12. (g) K1 and K2 at 16x16 tiles, and K1 at 9x9 (its row-crossing
   kernel): the tile shape is read at import, so a fresh interpreter per
   shape (this script with ``--tile 16x16`` and ``GSPLAT_TILE_X/Y``,
   started after the build and held until this phase) renders a seeded
   scene of 4,000 gaussians at 256x256 and holds K1, and K2 where the tile
   is whole warps, in each of their four forms against their plain
   versions by the rules of 4. and (f) (K1 within the channels'
   tolerances, n_contrib equal; K2's rows finite, pad slots zero, two
   launches bit-equal), and checks the warp map K1 and K2 share against
   the cull's boxes at the shape; its time is printed.  K1's and K2's CTAs per SM at C = 3, 5, 7 and a
   runtime C are printed beside ptxas's registers and spills (K1's also
   in 4. and (f));
13. (h) the render and evaluation command lines at 1920x1080: a
   NeRFstudio scene of (c)'s five cameras with targets rendered from the
   asset and a model directory with the asset perturbed by seeded noise;
   ``scripts.render.main(["-m", model, "--eval", "--inter_test_frames",
   "8", "--video"])`` with the counters zeroed just before (K3 and K1 once
   per view and path frame, every split's PNGs, the path output and the
   encoder it names, the test view's PNG bit-equal to ``renderer.render``
   quantised the same way), its seconds per view and
   ``render_path_frames``' ms per frame; ``scripts.metrics.main`` with
   seeded LPIPS weights named for this phase only (SSIM in [0, 1], PSNR
   and LPIPS finite, each view's PSNR recomputed from the PNGs within
   1e-6), LPIPS at 1080p on the card within 1e-5 relative of the CPU's;
   then (d)'s model rendered and scored through the same two CLIs;
14. (i) the appearance embedding and the live-viewer socket: (i.1) ten
   ``make_appearance_step`` steps in the JAX Trainer's numerics on phase
   8's state (bench.py's camera as camera 2 of 4) with the counters zeroed
   just before (K3, K1 and K2 in the packed quad form, and K4, once a
   step; no overflow, finite state, falling loss, only row 2 of the
   embedding moved), then that step and ``make_train_step`` alternated
   from one state (ms/step, device busy, the appearance's extra busy);
   (i.2) ``Trainer(use_appearance=True, gui_source_path=...)`` on (c)'s
   cameras with exact cull, 10 iterations with a save and a checkpoint
   (``appearance_embedding.npz`` beside the PLY,
   ``appearance_chkpnt10.npz`` reloading to equal tensors and moments);
   (i.3) during it, a loopback client on the port ``network_gui.init(
   "127.0.0.1", 0)`` bound asks for bench.py's camera 31 times with
   ``train = False`` and once with ``train = True, keep_alive = False``:
   every frame bit-equal to the quantised ``renderer.render`` of the
   model before the first iteration, K3 and K1 once per frame, training
   on to its last iteration; median and p90 of the warmed frames' round
   trip and of its parts clocked inside each exchange (receive, render,
   frame_bytes, send; the rest a remainder), and frame_bytes' readback
   and quantise apart; (i.4) ``scripts.train.main``
   on (d)'s scene with ``--able_appearance_embedding`` and the socket
   open on ``--port 0``, then resumed from its checkpoint (the appearance
   checkpoint loaded: step counts 10, then 15);
15. (j) multi-GPU training and rendering (``gsplat_tpu_torch/parallel``)
   on the one card: (j.1) the asset at bench.py's camera made at
   1920x1152 (36 tile rows; fovy from bench.py's formula, so the focal
   length is the 1080p camera's) rendered in D = 2 and D = 4 row slices
   one after another through ``tile_parallel.render_slice``, each slice's
   K5, K3 and K1 counted and timed, the slices concatenated bit-equal to the
   full render; (j.2) ``make_parallel_train_step`` at world size 1 over
   NCCL on phase 8's inputs, bit-equal to ``make_train_step`` from the
   same state, the two alternated for ms/step and device busy; (j.3) two
   ranks of this script (``--rank r 2 port dir``, started after the
   build and held at their stdin until this phase) sharing ``cuda:0``
   over gloo, one data-parallel step (camera r on rank r) and one 2-slice
   tile-sharded step at 1920x1152 in the 524,288-slot model, K3, K1, K2
   and K4 counted in each rank (K7 and K8 once each), the state bit-equal across the ranks and
   the gradients (a cold Adam step's first moments) and densification
   statistics within rtol 3e-3 and 1e-3 of each field's largest of the
   single-process oracles; (j.4) ``scripts.train.main`` with
   ``--multihost`` at world size 1 on (d)'s scene, writing (d)'s files;
16. (k) the viewing half on phase (h)'s PLY of the asset at 1920x1080,
   every ``composite_tiled`` call recorded (the ``"auto"`` paths make
   none): (k.1) ``viz/editor.py``: the PLY in 262,144 slots with seeded
   Adam moments, merged with itself translated (524,288 slots, the
   moments kept), a rotated box and class 1 selected, the merged scene
   and the box rendered (K3 and K1 once each), a copy moved and scaled,
   the box removed, a clip saved that reloads to the same rows; (k.2)
   ``scripts.visualize.main`` on (h)'s model directory in the rgb (a
   box), depth (a sub-scene) and segment (the class filter, a clip, the
   video) modes, six orbit frames each, K3 and K1 once a frame, each frame
   bit-equal to ``frame_for_mode(renderer.render(...))`` on its camera;
   (k.3) ``viz/render_app.RenderServer`` served on a loopback thread
   (every client socket with a timeout): the pages byte for byte,
   ``/api/splats`` and ``/api/viewer-info`` as ``pack_splats`` and
   ``scene_info``, ``/api/generate-image`` for every motion key and ``m``,
   ``,``, ``.``, ``space``, ``p``, ``b``, ``y`` (an 8-frame export), each
   PNG the twin server's ``render_png`` after the same key, K3 and K1 once
   a frame; then 20 warmed frames' round trip with the render,
   ``frame_for_mode``, the overlay and the PNG encode clocked apart;
   (k.4) ``tools/serve_asset_viewer`` on ``assets/trained_scene.ply``, one
   frame and one ``/api/splats``; (k.5) the backends on (g)'s seeded
   256x256 scene: ``"pallas"`` bit-equal to ``"auto"``, ``"jnp"`` to
   ``"reference"`` (K3, no K1), ``"jnp"`` within the JAX tests'
   tiled-against-Pallas tolerances of ``"auto"`` in the images and in one
   ``make_train_step`` step's gradients; one ``"jnp"`` render at the asset
   (its ms, peak memory, and the tiles over ``k_max`` where it departs
   from ``"auto"``);
17. (l) the data-prep half, the native I/O and DPT on (h)'s scene and PLY:
   (l.1) (h)'s five camera poses as SLAM poses through
   ``data/converters.slam_to_nerf`` (the poses of (h)'s transforms.json,
   float32-rounded), ``compute_block_seq``, ``split_blocks`` and
   ``nerf_to_poses_bounds``, then ``scripts.convert.main`` with a stub
   colmap written by the phase (the card's machine has none): the four
   command lines received, the ``--resize`` pyramid of the five 1080p
   images timed; (l.2) the native library loads, (h)'s PLY of the asset
   through ``read_ply``'s native path (counted) equal to the pure-python
   read, a ``points3D.bin`` of the asset's points written in COLMAP's
   binary layout and read both ways, each path's ms; (l.3) the published
   DPT-Hybrid (122,376,449 parameters) and DPT-Large at 384x384 and 672x384
   (the minimal resize of a 1080p frame) and the hybrid's 150-class
   segmentation head, from a seeded ``torch.Generator``: the card's output
   within 1e-4 of the largest magnitude of the CPU's, ms per image, device
   busy and peak memory; (l.4) ``scripts.run_monodepth.main`` into the
   scene's ``depth/`` (16-bit 1920x1080 PNGs), ``run_segmentation.main``
   at 150 classes (one view, timed) and at NUM_CLASS into ``segment/``,
   then ``scripts.train.main`` on the scene with ``--using_depth
   --depth_loss_choice L1_loss --using_seg`` for 10 iterations at 1080p
   with the counters zeroed just before: K3, K1, K2 and K4 once an
   iteration, the loss finite, the files written.

18. (m) preprocess, K5 and K6 (``csrc/preprocess.cu``): the asset in a
   model of 524,288 slots at bench.py's camera and that model repeated eight
   times (4,194,304 slots, the ``split2m.train`` cell's count): K5 against
   its plain version (every output equal) and K6 against its plain version
   on a seeded cotangent (on the valid slots each gradient within 1e-4 of
   itself plus 1e-4 of its field's median magnitude, the others zero), both
   timed on the device alone beside their plain versions and their byte
   bounds (K6's: 504 bytes a valid slot, 236 a dead one), with ptxas's
   registers and spills of every instantiation.  The table's rows take
   their launch counts from the render of phase 7 (K5) and the steps of
   phase 8 (K6), which check one of each a frame and a step.
19. (n) SSIM, K7 and K8 (``csrc/ssim.cu``): the asset's 1080p render of
   phase 7 against it with seeded noise added, at 1920x1080 and on their
   1777x1001 corner: K7's mean within 1e-6 relative of ``ssim_plain``'s,
   K8's gradient per entry within rtol 1e-4 plus 1e-4 of the plain
   gradient's largest magnitude, each bit-equal over two launches; at 1080p
   both timed on the device alone beside their operation bounds, their
   plain versions and ``ssim_plain``'s autograd chain, with ptxas's
   registers and spills.  The table's rows take their launch counts from
   phase 8's steps; every training phase checks one of each a step.

Each bound (``tools/workload.py::bound_ms``) is the largest of the bytes
over the HBM rate, the operations over the fp32 (or bf16) rate and the
exponentials over the SFU rate, and names the one that binds.

The last three lines are the kernel table as one JSON object (K1 to K4,
K3x, P1 to P4 with every variant, and K1's and K2's forms), the card line,
and
``{"ok": true, "device": {...}}``.  Without a usable card the
script exits 2 and prints no result.
"""
import atexit
import contextlib
import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from gsplat_tpu_torch.tools.timing import event_ms, median_ms

# Tolerances of the JAX tests between the Pallas path and the oracle
# (tests/test_pallas_composite.py:35-43).
ATOL = {"rgb": 3e-5, "alpha": 3e-5, "segment": 3e-5, "T_final": 3e-5,
        "depth": 3e-4}
W, H = 1920, 1080
NUM_CLASS = 2
ASSET = os.path.join("assets", "trained_scene_big.npz")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# ptxas's -v report of the build, kept for the phases that print K1's
# registers and spills
PTXAS = {"report": ""}
_K1_ENTRY = re.compile(r"composite_forward_kernelILi(\d+)ELi0ELi(\d+)ELb0E")


def k1_ptxas(C, bits):
    """ptxas's registers and spill stores of K1's production kernel at
    compile-time C in the form of Form bits ``bits`` (kFormQuad 1,
    kFormPacked 2, kFormOnes 4), from the build's report: "N registers,
    S bytes spilled"."""
    from gsplat_tpu_torch import _kernels
    entries = _kernels.ptxas_entries(PTXAS["report"], _K1_ENTRY)
    if (str(C), str(bits)) not in entries:
        return "not in the report"
    regs, spill = entries[(str(C), str(bits))]
    return f"{regs} registers, {spill} bytes spilled"


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def compare_k1(comp, packed, packed_p, C, width=W, height=H):
    """K1 output against its plain version: (max |diff| over the channels
    and T_final, pixels over tolerance per channel, n_contrib mismatches)."""
    channels = {"rgb": slice(0, 3), "depth": slice(3, 4),
                "segment": slice(4, 4 + NUM_CLASS), "alpha": slice(C - 1, C)}
    img, tf = comp.unpack_tiles(packed, C, width, height)
    img_p, tf_p = comp.unpack_tiles(packed_p, C, width, height)
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
    from gsplat_tpu_torch.tools import workload as wl
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
    ms = event_ms(lambda: seg.segment_sum_sorted(vals, sids, P, perm),
                  20)
    plain_ms = event_ms(lambda: seg.segment_sum_sorted_plain(
        vals, sids, P, perm), 5)
    library_ms = event_ms(library, 20)
    sort_ms = event_ms(lambda: torch.sort(gauss_id, stable=True), 20)
    # bytes these inputs need: each kept row once with its id and its
    # permutation entry, each output word once; one add per kept value
    nbytes = n_kept * (R * 4 + 4 + 8) + P * R * 4
    bound, by = wl.bound_ms(nbytes, n_kept * R)
    print(f"K4 [{card}]: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_add_ {library_ms:.4f} ms, the id sort before it "
          f"{sort_ms:.4f} ms; bound {bound:.4f} ms ({nbytes} bytes, "
          f"{n_kept * R} adds)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


def phase_k2(torch, comp, card, k1_args, packed, d_packed, P, C, tested,
             composited):
    """K2 on the asset's binning and K1's packed output, with a seeded
    cotangent (``tools.workload.asset_workload``'s), against its plain
    version."""
    from gsplat_tpu_torch.tools import workload as wl
    table, gauss_id, starts, counts, gx = k1_args
    Cg = C - 1                      # the ones channel gets no gradient row
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
    ms = event_ms(lambda: comp.composite_backward(*args), 10)
    nbytes = (table.numel() * 4 + int(counts.sum()) * 4
              + 2 * 4 * starts.shape[0] + 2 * packed.numel() * 4
              + d_k.numel() * 4)
    nops = wl.K2_TEST_OPS * tested + wl.k2_pair_ops(C, Cg) * composited
    bound, by = wl.bound_ms(nbytes, nops, nexp=tested)
    print(f"K2 [{card}]: kernel {ms:.4f} ms (with the zero fill of its "
          f"[{d_k.shape[0]}, {d_k.shape[1]}] output); bound {bound:.4f} ms "
          f"({by}; {nbytes} bytes; {nops} ops = {wl.K2_TEST_OPS} x {tested} "
          f"pairs up to n_contrib + {wl.k2_pair_ops(C, Cg)} x {composited} "
          f"composited; {tested} exponentials, one a pair up to n_contrib)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def bits_equal(torch, a, b):
    """Bit-for-bit equality of two tensors of one dtype (NaN patterns
    included)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool((a == b).all())


def phase_k3x(torch, card, bin_lib, pre, gx, gy, cap):
    """(a) K3's extras form at the asset's real stage-A sources, bit-equal
    to ``expand_plain``; then exact-cull ``bin_gaussians`` field by field
    against the same function with K3 and K3x swapped for their plain
    versions."""
    from gsplat_tpu_torch.tools import workload as wl
    t0 = time.perf_counter()
    rs = bin_lib.row_sources(pre, gx, gy, 128)
    IR = bin_lib.row_capacity(cap)
    rw_bits = bin_lib.meta_layout(gx, gx * gy, 128)[1]
    S = rs.offsets.shape[0]
    args = (rs.offsets, rs.meta, rs.gid, IR, rw_bits, gx, gy)
    out_k = bin_lib.expand(*args, extras=rs.extras)
    out_p = bin_lib.expand_plain(*args, extras=rs.extras)
    torch.cuda.synchronize()
    for name, a, b in zip(("ty", "gid", "extras"), out_k, out_p):
        check(bits_equal(torch, a, b),
              f"K3x: {name} differs from the plain version")
    rows_total = int(rs.rows_total)
    check(0 < rows_total <= IR, f"K3x: {rows_total} rows over {IR} slots")
    err = max(float((out_k[2] - out_p[2]).abs().max()),
              float((out_k[0] - out_p[0]).abs().max()),
              float((out_k[1] - out_p[1]).abs().max()))

    culled = bin_lib.bin_gaussians(pre, gx, gy, cap, cull="exact")
    kernel_expand = bin_lib.expand

    def plain_expand(offsets, meta, gid, I, rw_bits, grid_x, num_tiles,
                     extras=()):
        return bin_lib.expand_plain(offsets, meta, gid, I, rw_bits, grid_x,
                                    num_tiles, extras)

    bin_lib.expand = plain_expand
    try:
        culled_p = bin_lib.bin_gaussians(pre, gx, gy, cap, cull="exact")
    finally:
        bin_lib.expand = kernel_expand
    for f in culled._fields:
        check(torch.equal(getattr(culled, f), getattr(culled_p, f)),
              f"K3x: exact-cull binning field {f} differs from the plain "
              "version")
    check(not bool(culled.overflow), "K3x: exact-cull binning overflowed")
    full = bin_lib.bin_gaussians(pre, gx, gy, cap)
    print(f"K3x expand (extras): ty, gid and 8 extras bit-equal to the plain "
          f"version on {IR} row slots ({S} sources, rows_total "
          f"{rows_total}, I_R {IR}); exact-cull binning bit-equal field by "
          f"field; num_rendered / num_padded {int(culled.num_rendered)} / "
          f"{int(culled.num_padded)} with the cull, "
          f"{int(full.num_rendered)} / {int(full.num_padded)} without")
    ms = median_ms(lambda: bin_lib.expand(*args, extras=rs.extras))
    back_ms = event_ms(lambda: bin_lib.expand(*args, extras=rs.extras), 20)
    plain_ms = event_ms(lambda: bin_lib.expand_plain(
        *args, extras=rs.extras), 10)
    cull_ms = event_ms(lambda: bin_lib.bin_gaussians(
        pre, gx, gy, cap, cull="exact"), 10)
    none_ms = event_ms(lambda: bin_lib.bin_gaussians(pre, gx, gy, cap),
                       10)
    bound, by, nbytes, nops = wl.expand_bound(S, IR, rs.extras.shape[0])
    print(f"K3x [{card}]: kernel {ms:.5f} ms on the device alone "
          f"(timing.median_ms; {back_ms:.5f} ms a call back to back, host "
          f"included), plain {plain_ms:.4f} ms; bound "
          f"{bound:.5f} ms ({nbytes} bytes, {nops} ops); bin_gaussians "
          f"exact {cull_ms:.4f} ms, none {none_ms:.4f} ms; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


def check_k3_partition(torch, lib, bin_lib, args, what):
    """K3's partition as the kernel finds it (``gsplat_expand_partition``, K3
    launched through its C entry, so not counted), CTA by CTA equal to
    ``binning.expand_partition_plain``; returns the plain partition."""
    offsets, meta, gid, I, rw_bits, grid_x, num_tiles = args
    S = offsets.shape[0]
    items = lib.gsplat_expand_items()
    n = (S + I + items - 1) // items
    outs = [torch.empty(I, dtype=torch.int32, device=offsets.device)
            for _ in range(2)]
    part = torch.empty((n, 3), dtype=torch.int32, device=offsets.device)
    err = lib.gsplat_expand_partition(
        offsets.data_ptr(), meta.data_ptr(), gid.data_ptr(), S, I, rw_bits,
        grid_x, num_tiles, outs[0].data_ptr(), outs[1].data_ptr(),
        part.data_ptr(), torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"K3 partition ({what}): CUDA error {err}")
    plain = bin_lib.expand_partition_plain(offsets, I, items)
    for j, f in enumerate(("slot_start", "source_start", "first_owner")):
        bad = int((part[:, j] != getattr(plain, f)).sum())
        check(bad == 0, f"K3 partition ({what}): {f} differs from the plain "
              f"version in {bad} of {n} CTAs")
    return plain


def phase_k3_handmade(torch, card, bin_lib, wl, dev, lib):
    """K3 and K3x bit-equal to ``expand_plain`` on the hand-built sources at
    full scale (``workload.k3_full_sources``): a run of 200,000 empty
    sources, a source of 300,000 slots, offsets reaching 1.2 I; K3's
    partition equal to its plain version there."""
    hand = wl.k3_full_sources(dev)
    args = hand.args(wl.K3_FULL_I)
    part = check_k3_partition(torch, lib, bin_lib, args, "hand-built")
    times = {}
    for name, extras in (("K3", ()), ("K3x", hand.extras)):
        got = bin_lib.expand(*args, extras=extras)
        want = bin_lib.expand_plain(*args, extras=extras)
        check(all(bits_equal(torch, a, b) for a, b in zip(got, want)),
              f"{name}: hand-built sources differ from the plain version")
        times[name] = median_ms(lambda: bin_lib.expand(*args, extras=extras))
    print(f"K3 and K3x on hand-built sources: bit-equal to the plain version "
          f"on {wl.K3_FULL_I} slots ({hand.offsets.shape[0]} sources, "
          f"offsets up to {int(hand.offsets.max())}), K3's partition equal "
          f"to its plain version in all {part.slot_start.shape[0]} CTAs; "
          f"device alone [{card}] K3 {times['K3']:.5f} ms, K3x "
          f"{times['K3x']:.5f} ms")


def phase_cull_render(torch, card, model, cam, cap):
    """(b) ``rasterize`` with ``cull="exact"`` against ``cull="none"`` at
    the asset: images within the JAX test's tolerance
    (tests/test_rasterize_parity.py:145-191), and the gradients of the same
    loss within rtol 3e-3, atol 1e-3."""
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    t0 = time.perf_counter()
    dev = model.device
    p = model.params
    inputs = [p.xyz, T.scaling_activation(p.scaling), p.rotation,
              T.opacity_activation(p.opacity[:, 0]), model.get_features,
              T.segment_activation(p.segment)]
    names = ["means3d", "scales", "rotations", "opacities", "shs",
             "segments"]
    bg = torch.tensor([0.15, 0.3, 0.1], device=dev)

    def run(cull):
        cfg = RasterizeConfig(width=W, height=H, sh_degree=3,
                              num_class=NUM_CLASS, max_instances=cap,
                              cull=cull)
        leaves = [x.detach().clone().requires_grad_(True) for x in inputs]
        out = rasterize(cfg, *leaves[:5], cam.world_view_transform,
                        cam.full_proj_transform, cam.camera_center,
                        cam.tan_fovx, cam.tan_fovy, bg, segments=leaves[5],
                        device=dev)
        loss = ((out["render"] ** 2).sum() + out["depth"].sum()
                + (out["alpha"] ** 2).sum())
        grads = torch.autograd.grad(loss, leaves)
        return {k: v.detach() if torch.is_tensor(v) else v
                for k, v in out.items()}, grads

    out0, g0 = run("none")
    out1, g1 = run("exact")
    torch.cuda.synchronize()
    check(not bool(out0["overflow"]) and not bool(out1["overflow"]),
          "cull render: overflow")
    diffs = {}
    for k, atol in (("render", 1e-6), ("T_final", 1e-6), ("depth", 1e-5),
                    ("alpha", 1e-6), ("segment", 1e-6)):
        d = (out1[k] - out0[k]).abs()
        diffs[k] = float(d.max())
        check(bool((d <= atol + 1e-5 * out0[k].abs()).all()),
              f"cull render: {k} differs beyond rtol 1e-5, atol {atol}")
    gerr = {}
    for n, a, b in zip(names, g1, g0):
        d = (a - b).abs()
        gerr[n] = float(d.max())
        check(bool((d <= 1e-3 + 3e-3 * b.abs()).all()),
              f"cull render: gradient of {n} beyond rtol 3e-3, atol 1e-3")
    print(f"cull render {W}x{H}: num_rendered {int(out1['num_rendered'])} "
          f"with exact cull, {int(out0['num_rendered'])} without; max |diff| "
          f"of the images {json.dumps(diffs)}; of the gradients "
          f"{json.dumps(gerr)}; phase {time.perf_counter() - t0:.1f} s")


def alternate_steps(torch, np, card, steps, order, state, batch, lrs):
    """Train steps of each of ``steps`` (each returning its metrics last)
    from the same state, in ``order`` (each name twice, as a, b, b, a):
    ms/step (CUDA events per step),
    device busy ms/step (profiler) and the launches of one step, printed
    and returned per name."""
    from gsplat_tpu_torch import _kernels
    t0 = time.perf_counter()
    times = {name: [] for name in steps}
    for name in order:
        steps[name](*state, batch, lrs)          # warm the allocator
        for _ in range(4):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = steps[name](*state, batch, lrs)
            b.record()
            torch.cuda.synchronize()
            check(not bool(out[-1]["overflow"]), f"step {name}: overflow")
            times[name].append(a.elapsed_time(b))
    res = {}
    for name in steps:
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        m = steps[name](*state, batch, lrs)[-1]
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        med = float(np.median(times[name]))
        busy = profile_window(torch, lambda: steps[name](*state, batch, lrs),
                              5, f"step ({name})", med, card, top=6)
        res[name] = dict(ms=med, busy=busy, launches=launches)
        print(f"train step {name} [{card}]: median {med:.3f} ms/step "
              f"over {len(times[name])} steps (p10 "
              f"{np.percentile(times[name], 10):.3f}, p90 "
              f"{np.percentile(times[name], 90):.3f}), device busy "
              f"{'not measured' if busy is None else f'{busy:.3f}'} "
              f"ms/step, launches per step {json.dumps(launches)}, "
              f"num_rendered {int(m['num_rendered'])}, num_padded "
              f"{int(m['num_padded'])}")
    print(f"alternated steps ({', '.join(steps)}): "
          f"{time.perf_counter() - t0:.1f} s")
    return res


TRAIN_CAPACITY = 524288
TRAIN_STEPS = 10
# The reference's inverse-depth L1 turns a pixel no gaussian touches
# (depth 0) into 1e6; a third of the asset's view is such pixels, and at the
# default weight 0.1 that constant (and its jumps when a pixel's coverage
# flips) would swamp the float32 loss.  The weight is cut so the depth
# channel still gets a real cotangent and the loss stays readable.
TRAIN_LAMBDA_DEPTH = 1e-7


TRAIN_NOISE = dict(xyz=0.005, features_dc=0.05, features_rest=0.01,
                   scaling=0.05, rotation=0.02, opacity=0.2, segment=0.3)


def train_model(torch, model):
    """The asset in a model of TRAIN_CAPACITY slots, Adam state set up."""
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    P = model.capacity
    tm = GaussianModel(3, num_class=NUM_CLASS, capacity=TRAIN_CAPACITY,
                       device=model.device)
    for dst, src in zip(tm.params, model.params):
        dst[:P] = src
    tm.aux.alive[:P] = True
    tm.active_sh_degree = 3
    tm.training_setup()
    return tm


def perturbed(torch, params, P, gen):
    """``params`` with its first P rows moved by seeded noise."""
    return params._replace(**{
        k: torch.cat([v[:P] + TRAIN_NOISE[k] * torch.randn(
            v[:P].shape, generator=gen, device=v.device), v[P:]])
        for k, v in params._asdict().items()})


def train_inputs(torch, cam, model, cap):
    """What the training phases start from: the asset in a model of
    TRAIN_CAPACITY slots, the camera's batch with targets rendered from
    the unperturbed asset, the state with parameters perturbed by noise
    from a generator seeded 7 (returned too), the optimization params
    with TRAIN_LAMBDA_DEPTH and the learning-rate schedule."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.train import schedules, trainer
    dev = model.device
    tm = train_model(torch, model)
    target = renderer.render(cam, tm, max_instances=cap, device=dev)
    check(not bool(target["overflow"]), "train: target render overflowed")
    batch = trainer.camera_batch(
        cam, gt_depth=target["depth_raw"][None],
        gt_seg=torch.argmax(target["segment"], dim=0), device=dev)
    batch["gt_image"] = target["render"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    state = (perturbed(torch, tm.params, model.capacity, gen), tm.opt_state,
             tm.aux)
    opt = OptimizationParams()
    opt.lambda_depth = TRAIN_LAMBDA_DEPTH
    return dict(batch=batch, state=state, gen=gen, opt=opt,
                lr_fn=schedules.make_lr_fn(opt, 1.0),
                untouched=int((target["depth_raw"] <= 0).sum()))


def phase_train(torch, np, card, cam, model, cap):
    """The training path through ``make_train_step`` at full width: the
    asset in a model of TRAIN_CAPACITY slots, targets rendered from the
    unperturbed asset, parameters perturbed by seeded noise, TRAIN_STEPS Adam
    steps, the exact-cull and plain steps alternated from one state, one
    ``densify_and_prune``, one more step.  Returns the launch counts of the
    steps, the step count and the densification threshold and extent that
    fired."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.models import adam, densify
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.train import trainer

    dev = model.device
    P = model.capacity
    ti = train_inputs(torch, cam, model, cap)
    batch, gen, opt, lr_fn = ti["batch"], ti["gen"], ti["opt"], ti["lr_fn"]
    untouched = ti["untouched"]
    params, opt_state, aux = ti["state"]
    cfg = RasterizeConfig(width=W, height=H, sh_degree=3,
                          num_class=NUM_CLASS, max_instances=cap)
    step = trainer.make_train_step(cfg, opt, 3, "L1_loss", True,
                                   torch.zeros(3, device=dev), device=dev)

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
    check(all(launches[k] == TRAIN_STEPS for k in (
        "preprocess_forward", "preprocess_backward", "ssim_forward",
        "ssim_backward", "expand", "composite_forward", "composite_backward",
        "segment_sum"))
          and launches["expand_extras"] == 0,
          "train: K5, K6, K7, K8, K3, K1, K2 and K4 did not each launch once "
          "per step")
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

    # the same state through the exact-cull step and the plain one
    cfg_exact = RasterizeConfig(width=W, height=H, sh_degree=3,
                                num_class=NUM_CLASS, max_instances=cap,
                                cull="exact")
    steps = {"none": step, "exact": trainer.make_train_step(
        cfg_exact, opt, 3, "L1_loss", True, torch.zeros(3, device=dev),
        device=dev)}
    res = alternate_steps(torch, np, card, steps,
                          ("none", "exact", "exact", "none"),
                          (params, opt_state, aux), batch, lr_fn(TRAIN_STEPS))
    launches_exact = res["exact"]["launches"]
    check(launches_exact["expand_extras"] == 1
          and launches_exact["expand"] == 1,
          "cull exact step: K3x and K3 not launched once each")

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
    return launches, TRAIN_STEPS, thr, extent


TRAINER_ITERS = 40
# the Trainer and the command line run the JAX Trainer's numerics: K1 and
# K2 in their packed quad form
CULL_KERNELS = ("expand_extras", "expand", "composite_forward_packed_quad",
                "composite_backward_packed_quad", "segment_sum",
                "ssim_forward", "ssim_backward")


class MemoryScene:
    """What ``Trainer`` reads of a scene, held in memory: cameras with
    their targets, the extent, and ``save`` (the PLY of an iteration)."""

    def __init__(self, model, train, test, extent, model_path):
        self.gaussians = model
        self.train, self.test = train, test
        self.cameras_extent = extent
        self.model_path = model_path

    def getTrainCameras(self):
        return self.train

    def getTestCameras(self):
        return self.test

    def save(self, iteration):
        self.gaussians.save_ply(os.path.join(
            self.model_path, "point_cloud", f"iteration_{iteration}",
            "point_cloud.ply"))


# the cameras of phases (c) and (h), near bench.py's
TRAINER_POSES = [[0.0, 0.6, 4.2], [0.15, 0.6, 4.2], [-0.15, 0.55, 4.25],
                 [0.0, 0.7, 4.1], [0.08, 0.62, 4.15]]


def target_camera(torch, np, renderer, model, T, name, uid):
    """A Camera at bench.py's pose moved to ``T``, with its image, depth and
    segment labels rendered from ``model``."""
    from gsplat_tpu_torch.core.cameras import Camera
    fovx = math.radians(62.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * H / W)
    cam = Camera(colmap_id=uid, R=np.eye(3), T=np.array(T), FoVx=fovx,
                 FoVy=fovy, image=np.zeros((3, H, W), np.float32),
                 image_name=name, uid=uid)
    out = renderer.render(cam, model, device=model.device)
    check(not bool(out["overflow"]), f"{name}: target render overflowed")
    cam.image = out["render"].clamp(0, 1).cpu().numpy()
    cam.depth = out["depth_raw"][None].cpu().numpy()
    cam.segment = torch.argmax(out["segment"], dim=0).to(
        torch.int32).cpu().numpy()
    return cam


def phase_trainer(torch, np, card, model, thr, extent):
    """(c) ``Trainer`` at 1080p with exact cull: the asset in
    TRAIN_CAPACITY slots, perturbed, on four cameras near bench.py's with
    targets from the unperturbed asset (one more as the test split);
    autosized capacity; densification at 20 and 30 (threshold and extent
    from the training phase), an opacity reset at 30, test, save and
    checkpoint at the last iteration.  Returns the launch counts of the
    run."""
    from gsplat_tpu_torch import _kernels, renderer
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.train.trainer import Trainer
    t0 = time.perf_counter()
    dev = model.device
    P = model.capacity
    tm = train_model(torch, model)
    cams = [target_camera(torch, np, renderer, tm, T, f"view{i}", i)
            for i, T in enumerate(TRAINER_POSES)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    tm.params = perturbed(torch, tm.params, P, gen)
    tm.training_setup()
    opt = OptimizationParams()
    opt.lambda_depth = TRAIN_LAMBDA_DEPTH
    opt.densify_from_iter = 10
    opt.densification_interval = 10
    opt.densify_until_iter = TRAINER_ITERS
    opt.opacity_reset_interval = 30
    opt.densify_grad_threshold = thr
    t_setup = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as out_dir:
        scene = MemoryScene(tm, cams[:4], cams[4:], extent, out_dir)
        tr = Trainer(tm, scene, opt, depth_loss_choice="L1_loss",
                     use_seg=True, cull="exact", max_instances=0,
                     model_path=out_dir)
        rows, densified = [], []

        def record(it, metrics, trainer):
            rows.append({"it": it, "t": time.perf_counter(),
                         "loss": float(metrics["loss"]),
                         "overflow": bool(metrics["overflow"]),
                         "num_rendered": int(metrics["num_rendered"]),
                         "num_padded": int(metrics["num_padded"]),
                         "capacity": trainer.max_instances,
                         "launches": dict(_kernels.launch_counts)})
            d = trainer.last_densify
            if d is not None and d not in densified:
                densified.append(dict(d))

        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t1 = time.perf_counter()
        tr.train(TRAINER_ITERS, log_every=1, callback=record,
                 test_iterations={TRAINER_ITERS},
                 save_iterations={TRAINER_ITERS},
                 checkpoint_iterations={TRAINER_ITERS})
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t1
        launches = dict(_kernels.launch_counts)
        check(len(rows) == TRAINER_ITERS, "trainer: not every step logged")
        prev = {k: 0 for k in CULL_KERNELS}
        for r in rows:
            check(all(r["launches"][k] - prev[k] == 1 for k in CULL_KERNELS),
                  f"trainer: step {r['it']} did not launch K3x, K3, K1, K2, "
                  f"K4, K7 and K8 once each ({r['launches']})")
            prev = r["launches"]
        for i, r in enumerate(rows):
            if r["overflow"]:
                later = [q["capacity"] for q in rows[i + 1:]]
                check(later and max(later) > r["capacity"],
                      f"trainer: overflow at {r['it']} not followed by a "
                      "regrow")
        losses = [r["loss"] for r in rows]
        check(all(math.isfinite(x) for x in losses), "trainer: non-finite "
              "loss")
        # densification at 20 moves and splits gaussians and the opacity
        # reset at 30 darkens every one: the loss is held before them
        before = float(np.mean(losses[15:20]))
        check(before < float(np.mean(losses[:5])),
              "trainer: the loss did not fall before the densification")
        check(any(d["n_cloned"] + d["n_split"] > 0 for d in densified),
              f"trainer: densify did not fire ({densified})")
        ply = os.path.join(out_dir, "point_cloud", f"iteration_"
                           f"{TRAINER_ITERS}", "point_cloud.ply")
        check(os.path.exists(ply), "trainer: no PLY")
        with open(os.path.join(out_dir, "eval_log.jsonl")) as f:
            evals = [json.loads(x) for x in f]
        check([e["split"] for e in evals] == ["test", "train"],
              "trainer: eval_log.jsonl")
        t2 = time.perf_counter()
        back = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device=dev)
        ck = os.path.join(out_dir, f"chkpnt{TRAINER_ITERS}.npz")
        check(back.restore_checkpoint(ck) == TRAINER_ITERS,
              "trainer: checkpoint iteration")
        for name, a, b in (("params", back.params, tm.params),
                           ("aux", back.aux, tm.aux),
                           ("mu", back.opt_state.mu, tm.opt_state.mu),
                           ("nu", back.opt_state.nu, tm.opt_state.nu)):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"trainer: checkpoint {name} differs")
        check(int(back.opt_state.count) == int(tm.opt_state.count),
              "trainer: checkpoint step count")
        t_restore = time.perf_counter() - t2
        ply_mb = os.path.getsize(ply) / 1e6
        ck_mb = os.path.getsize(ck) / 1e6
    caps = sorted({r["capacity"] for r in rows})
    gaps = np.diff([r["t"] for r in rows]) * 1e3
    print(f"trainer {W}x{H} [{card}]: {TRAINER_ITERS} iterations in "
          f"{t_train:.1f} s with the test renders, save and checkpoint; "
          f"median {np.median(gaps):.3f} ms/iteration between the "
          f"callbacks (p10 {np.percentile(gaps, 10):.3f}, p90 "
          f"{np.percentile(gaps, 90):.3f}; each callback reads the loss "
          f"back); "
          f"capacities {caps}; overflowing steps "
          f"{sum(r['overflow'] for r in rows)}; num_rendered "
          f"{rows[0]['num_rendered']} -> {rows[-1]['num_rendered']}, "
          f"num_padded {rows[0]['num_padded']} -> {rows[-1]['num_padded']}; "
          f"loss {np.mean(losses[:5]):.6f} (first 5) -> {before:.6f} "
          f"(16-20, before the densification), {np.mean(losses[25:30]):.6f}"
          f" (26-30, before the reset), {losses[-1]:.6f} (last); densify "
          f"{json.dumps(densified)}; eval {json.dumps(evals)}; launches "
          f"{json.dumps(launches)}; PLY {ply_mb:.1f} MB, checkpoint "
          f"{ck_mb:.1f} MB, restored equal in {t_restore:.1f} s; setup "
          f"{t_setup:.1f} s, phase {time.perf_counter() - t0:.1f} s")
    return launches


def write_nerfstudio(np, out_dir, cams, pts, cols):
    """A NeRFstudio scene of ``cams`` (port ``Camera``s holding their
    images): each image as an 8-bit PNG, ``transforms.json`` with the first
    camera's focal lengths, and ``pts`` with their 8-bit colors ``cols`` as
    ``points3d.ply`` through ``readers.store_ply``."""
    from PIL import Image

    from gsplat_tpu_torch.core.cameras import fov2focal
    from gsplat_tpu_torch.data.readers import store_ply
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    frames = []
    for cam in cams:
        name = f"{cam.image_name}.png"
        img = (np.clip(cam.image, 0, 1).transpose(1, 2, 0) * 255).astype(
            np.uint8)
        Image.fromarray(img).save(os.path.join(out_dir, "images", name))
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = np.asarray(cam.R).T, cam.T
        c2w = np.linalg.inv(w2c)
        c2w[:, 1:3] *= -1          # the readers flip NeRF axes back
        frames.append({"file_path": f"images/{name}",
                       "transform_matrix": c2w.tolist()})
    c = cams[0]
    with open(os.path.join(out_dir, "transforms.json"), "w") as f:
        json.dump({"fl_x": fov2focal(c.FoVx, c.image_width),
                   "fl_y": fov2focal(c.FoVy, c.image_height),
                   "w": c.image_width, "h": c.image_height,
                   "frames": frames}, f)
    store_ply(os.path.join(out_dir, "points3d.ply"), pts, cols)


def write_scene(torch, np, renderer, out_dir, n=400, n_cams=8, width=128,
                height=96, device="cuda"):
    """A NeRFstudio scene written with the port: a seeded cloud rendered by
    ``renderer.render`` from cameras orbiting the origin (``write_nerfstudio``)."""
    from gsplat_tpu_torch.core import sh as sh_lib
    from gsplat_tpu_torch.core.cameras import Camera
    from gsplat_tpu_torch.models.gaussians import params_from_numpy
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((n, 3)).astype(np.float32) * 0.8
    cols = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    f_dc = np.zeros((n, 1, 3), np.float32)
    f_dc[:, 0] = sh_lib.rgb_to_sh(cols)
    model = params_from_numpy(dict(
        xyz=pts, features_dc=f_dc,
        features_rest=np.zeros((n, 15, 3), np.float32),
        scaling=rng.standard_normal((n, 3)).astype(np.float32) * 0.3 - 2.2,
        rotation=rng.standard_normal((n, 4)).astype(np.float32),
        opacity=rng.uniform(0.5, 2.5, (n, 1)).astype(np.float32),
        segment=np.zeros((n, NUM_CLASS), np.float32)), device=device)
    fovx = math.radians(60.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    cams = []
    for i in range(n_cams):
        ang = 2 * math.pi * i / n_cams
        campos = np.array([4 * math.sin(ang), 0.6, 4 * math.cos(ang)])
        fwd = -campos / np.linalg.norm(campos)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(fwd, right)
        up /= np.linalg.norm(up)
        r_w2c = np.stack([right, up, fwd])
        cam = Camera(colmap_id=i, R=r_w2c.T, T=-r_w2c @ campos, FoVx=fovx,
                     FoVy=fovy, image=np.zeros((3, height, width), np.float32),
                     image_name=f"frame_{i:03d}", uid=i)
        cam.image = renderer.render(cam, model, device=device)[
            "render"].clamp(0, 1).cpu().numpy()
        cams.append(cam)
    write_nerfstudio(np, out_dir, cams, pts, (cols * 255).astype(np.uint8))


def phase_cli(torch, np, card, work):
    """(d) The command line, in process, on a NeRFstudio scene written with
    the port under ``work``: ``--cull exact --disable_gui_server`` on the
    card.  Returns its launch counts and the model directory, which phase
    (h) renders and scores."""
    from gsplat_tpu_torch import _kernels, renderer
    from gsplat_tpu_torch.scripts import train as train_cli
    t0 = time.perf_counter()
    iters = 30
    scene_dir = os.path.join(work, "cli_scene")
    out = os.path.join(work, "cli_model")
    write_scene(torch, np, renderer, scene_dir)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    train_cli.main([
        "-s", scene_dir, "-m", out, "--cull", "exact",
        "--disable_gui_server", "--iterations_override", str(iters),
        "--test_iterations", str(iters), "--densify_from_iter", "10",
        "--densification_interval", "10",
        "--densify_grad_threshold", "2e-5", "--eval"])
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    for f in ("cfg_args", "train_log.jsonl", "eval_log.jsonl",
              "cameras.json", "input.ply",
              os.path.join("point_cloud", f"iteration_{iters}",
                           "point_cloud.ply")):
        check(os.path.exists(os.path.join(out, f)), f"cli: no {f}")
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(x) for x in f]
    with open(os.path.join(out, "eval_log.jsonl")) as f:
        evals = [json.loads(x) for x in f]
    check(launches["expand_extras"] >= iters,
          f"cli: K3x launched {launches['expand_extras']} times")
    check(all(launches[k] > 0 for k in CULL_KERNELS), "cli: a kernel of the "
          "path did not launch")
    check(all(math.isfinite(r["loss"]) for r in log), "cli: non-finite loss")
    print(f"cli [{card}]: {iters} iterations on a 128x96 NeRFstudio scene "
          f"(8 cameras, 400 gaussians), launches {json.dumps(launches)}; "
          f"train_log {json.dumps(log)}; eval {json.dumps(evals)}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return launches, out


# (h) the render and evaluation command lines on the card: the asset at
# 1920x1080 through scripts.render and scripts.metrics, then phase (d)'s
# model through the same two
RENDER_PATH_FRAMES = 8
LPIPS_NET = "alex"


def write_lpips_weights(np, path, seed=3):
    """Seeded LPIPS_NET weights in the npz layout ``viz/lpips.py`` reads
    (the layout ``tools/convert_lpips_weights.py`` writes): N(0, 0.05)
    convs and biases, U(0, 0.2) linear weights."""
    from gsplat_tpu_torch.viz.lpips import NET_SPECS
    rng = np.random.default_rng(seed)
    spec = NET_SPECS[LPIPS_NET]
    z = {"net_type": np.asarray(LPIPS_NET)}
    cin = 3
    convs = [arg for kind, arg in spec["layers"] if kind == "conv"]
    for i, (cout, k, _, _) in enumerate(convs):
        z[f"conv{i}_w"] = (rng.standard_normal((cout, cin, k, k)) * 0.05
                           ).astype(np.float32)
        z[f"conv{i}_b"] = (rng.standard_normal(cout) * 0.05).astype(
            np.float32)
        cin = cout
    for j, c in enumerate(spec["channels"]):
        z[f"lin{j}_w"] = rng.uniform(0, 0.2, c).astype(np.float32)
    np.savez(path, **z)


@contextlib.contextmanager
def clocked_calls(torch, module, names):
    """Each function of ``module`` named in ``names`` replaced, while the
    block runs, by one that appends its seconds, synchronised on the card
    before and after, to the yielded {name: [seconds of each call]}; a call
    that raises is not recorded."""
    seconds = {name: [] for name in names}
    orig = {name: getattr(module, name) for name in names}

    def clocked(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[name](*args, **kw)
            torch.cuda.synchronize()
            seconds[name].append(time.perf_counter() - t)
            return out
        return call

    try:
        for name in names:
            setattr(module, name, clocked(name))
        yield seconds
    finally:
        for name, fn in orig.items():
            setattr(module, name, fn)


def run_cli(main, argv, torch=None, module=None, timed=()):
    """``main(argv)`` with its standard output captured and echoed; returns
    what it printed and {name: [seconds of each call]} of the functions of
    ``module`` named in ``timed``, each call synchronised on the card."""
    import io
    buf = io.StringIO()
    with clocked_calls(torch, module, timed) as seconds, \
            contextlib.redirect_stdout(buf):
        main(argv)
    sys.stdout.write(buf.getvalue())
    return buf.getvalue(), seconds


def phase_render_cli(torch, np, card, model, work, cli_model):
    """(h) The render and evaluation command lines at 1920x1080: a
    NeRFstudio scene of the five cameras of phase (c) with targets rendered
    from the asset, and a model directory holding ``cfg_args`` and the
    asset perturbed by seeded noise as the PLY of iteration 1.  The render
    CLI with the counters zeroed just before (K3 and K1 once per view and
    path frame; every split's PNGs; the path video or frames and the
    encoder it names; the test view's PNG bit-equal to ``renderer.render``
    of the same camera, quantised the same way), its seconds per view and
    ``render_path_frames``' ms per frame; the metrics CLI with seeded
    LPIPS weights named for this phase only (SSIM in [0, 1], PSNR and
    LPIPS finite, each view's PSNR equal to the one recomputed from the
    PNGs read back within 1e-6); LPIPS at 1080p on the card against the
    CPU within 1e-5 relative; then phase (d)'s model through both CLIs."""
    from argparse import Namespace

    from PIL import Image

    from gsplat_tpu_torch import _kernels, renderer
    from gsplat_tpu_torch.core import sh as sh_lib
    from gsplat_tpu_torch.data.scene import Scene
    from gsplat_tpu_torch.models.gaussians import (GaussianModel,
                                                   params_from_numpy)
    from gsplat_tpu_torch.scripts import metrics as metrics_cli
    from gsplat_tpu_torch.scripts import render as render_cli
    from gsplat_tpu_torch.train import losses as L
    from gsplat_tpu_torch.viz.lpips import LPIPS
    t0 = time.perf_counter()
    dev = model.device
    P = model.capacity
    scene_dir = os.path.join(work, "render_scene")
    model_dir = os.path.join(work, "render_model")
    cams = [target_camera(torch, np, renderer, model, T, f"view{i}", i)
            for i, T in enumerate(TRAINER_POSES)]
    xyz = model.params.xyz.cpu().numpy()
    rgb = sh_lib.sh_to_rgb_dc(model.params.features_dc[:, 0]).clamp(0, 1)
    write_nerfstudio(np, scene_dir, cams, xyz,
                     (rgb.cpu().numpy() * 255).astype(np.uint8))
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    noisy = perturbed(torch, model.params, P, gen)
    params_from_numpy({k: v.cpu().numpy() for k, v in
                       noisy._asdict().items()}, device=dev).save_ply(
        os.path.join(model_dir, "point_cloud", "iteration_1",
                     "point_cloud.ply"))
    cfg = Namespace(sh_degree=3, source_path=scene_dir, model_path=model_dir,
                    images="images", resolution=1, white_background=False,
                    data_device="cuda", eval=True, using_depth=False,
                    using_seg=False, num_class=NUM_CLASS,
                    able_appearance_embedding=False)
    with open(os.path.join(model_dir, "cfg_args"), "w") as f:
        f.write(str(cfg))
    t_setup = time.perf_counter() - t0

    n_views = len(cams)
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t1 = time.perf_counter()
    said, seconds = run_cli(render_cli.main, [
        "-m", model_dir, "--eval", "--inter_test_frames",
        str(RENDER_PATH_FRAMES), "--video"], torch, render_cli,
        ("render_set", "render_path_frames"))
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t1
    launches = dict(_kernels.launch_counts)
    want = n_views + RENDER_PATH_FRAMES
    check(launches["expand"] == want and launches["composite_forward"] == want,
          f"render CLI: K3 and K1 did not launch once per view and path "
          f"frame ({want}): {json.dumps(launches)}")
    for split, n in (("train", n_views - 1), ("test", 1)):
        for sub in ("renders", "gt", "depth"):
            d = os.path.join(model_dir, split, "ours_1", sub)
            check(len(os.listdir(d)) == n,
                  f"render CLI: {split}/{sub} holds {os.listdir(d)}")
    enc = re.search(r"\[video\] encoder (\w+)", said)
    check(enc is not None, "render CLI: no encoder named")
    video = os.path.join(model_dir, "path.mp4")
    frames_dir = os.path.join(model_dir, "path_frames")
    check(len(os.listdir(frames_dir)) == RENDER_PATH_FRAMES
          and (enc[1] == "none" or os.path.getsize(video) > 0),
          f"render CLI: path output ({enc[0]})")

    s_view = sum(seconds["render_set"]) / n_views
    ms_frame = sum(seconds["render_path_frames"]) * 1e3 / RENDER_PATH_FRAMES

    gm = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device=dev)
    scene = Scene(cfg, gm, load_iteration=-1, shuffle=False)
    out = renderer.render(scene.getTestCameras()[0], gm, bg_color=np.zeros(3),
                          device=dev)
    png = np.asarray(Image.open(os.path.join(
        model_dir, "test", "ours_1", "renders", "00000.png")))
    check(np.array_equal(png, render_cli.quantize(out["render"].cpu().numpy())),
          "render CLI: the test view's PNG differs from renderer.render")

    weights = os.path.join(work, "lpips_seeded.npz")
    write_lpips_weights(np, weights)
    os.environ["GSPLAT_LPIPS_WEIGHTS"] = weights
    try:
        t4 = time.perf_counter()
        run_cli(metrics_cli.main, ["-m", model_dir])
        t_metrics = time.perf_counter() - t4
    finally:
        del os.environ["GSPLAT_LPIPS_WEIGHTS"]
    with open(os.path.join(model_dir, "results.json")) as f:
        res = json.load(f)["ours_1"]
    with open(os.path.join(model_dir, "per_view.json")) as f:
        per_view = json.load(f)["ours_1"]
    check(0 <= res["SSIM"] <= 1 and math.isfinite(res["PSNR"])
          and math.isfinite(res["LPIPS"]), f"metrics CLI: {res}")
    tdir = os.path.join(model_dir, "test", "ours_1")
    renders, gts, names = metrics_cli.read_images(
        os.path.join(tdir, "renders"), os.path.join(tdir, "gt"))
    for r, g, name in zip(renders, gts, names):
        again = float(L.psnr(torch.from_numpy(r).to(dev),
                             torch.from_numpy(g).to(dev)))
        check(abs(again - per_view["PSNR"][name]) <= 1e-6,
              f"metrics CLI: {name} PSNR {per_view['PSNR'][name]} against "
              f"{again} from the PNGs")
    lp_card = LPIPS(weights, device=dev)(renders[0], gts[0])
    lp_cpu = LPIPS(weights, device="cpu")(renders[0], gts[0])
    check(abs(lp_card - lp_cpu) <= 1e-5 * abs(lp_cpu),
          f"LPIPS at {W}x{H}: card {lp_card} against the CPU's {lp_cpu}")

    _kernels.reset_launch_counts()
    run_cli(render_cli.main, ["-m", cli_model])
    run_cli(metrics_cli.main, ["-m", cli_model])
    cli_launches = dict(_kernels.launch_counts)
    with open(os.path.join(cli_model, "results.json")) as f:
        cli_res = json.load(f)
    check(cli_launches["expand_extras"] == 0
          and cli_launches["composite_forward"] > 0
          and all(0 <= m["SSIM"] <= 1 and math.isfinite(m["PSNR"])
                  for m in cli_res.values()),
          f"phase (d)'s model through the CLIs: {json.dumps(cli_res)}, "
          f"launches {json.dumps(cli_launches)}")
    print(f"render CLI (h) {W}x{H} [{card}]: {t_cli:.2f} s for {n_views} "
          f"views and {RENDER_PATH_FRAMES} path frames with the scene and "
          f"PLY load and the video ({enc[1]}); render_set {s_view:.3f} s "
          f"per view (render and three PNG encodes); render_path_frames "
          f"{ms_frame:.2f} ms per frame (render and readback); launches "
          f"{json.dumps(launches)}")
    print(f"metrics CLI (h) [{card}]: {json.dumps(res)} in {t_metrics:.2f} s "
          f"(LPIPS '{LPIPS_NET}' on seeded weights: card {lp_card:.9g}, CPU "
          f"{lp_cpu:.9g}); phase (d)'s 128x96 model {json.dumps(cli_res)}; "
          f"setup {t_setup:.1f} s, phase {time.perf_counter() - t0:.1f} s")


# (i) the appearance embedding and the live-viewer socket at 1080p: the
# appearance step on phase 8's state in the JAX Trainer's numerics, the
# Trainer with both on (c)'s cameras serving a loopback client, and the
# command line with the socket open and the appearance resumed
APP_CAMERAS = 4
APP_UID = 2              # bench.py's camera as camera 2 of 4
APP_TRAINER_ITERS = 10
SOCKET_FRAMES = 31       # train = False; then one train = True, keep_alive
SOCKET_TIMEOUT = 120.0   # = False: 32 frames served at the first poll, the
                         # first cold and left out of the statistics


def phase_appearance_step(torch, np, card, w):
    """(i.1) ``make_appearance_step`` in the JAX Trainer's numerics on
    phase 8's state: TRAIN_STEPS steps with the counters zeroed just before
    (K3, K1 and K2 in the packed quad form, K4, K7 and K8, once a step;
    no overflow, finite state, falling loss, only the camera's row of the
    embedding moved), then that step and ``make_train_step`` alternated
    from one state (default, appearance, appearance, default): ms/step,
    device busy ms/step and the appearance's extra busy time.  Returns the
    launch counts of the steps."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.models import appearance as app_lib
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.train import trainer
    t0 = time.perf_counter()
    sc = w.scene
    model, cam, cap = sc["model"], sc["cam"], sc["cap"]
    dev = model.device
    ti = train_inputs(torch, cam, model, cap)
    state, opt, lr_fn = ti["state"], ti["opt"], ti["lr_fn"]
    batch = dict(ti["batch"], uid=torch.tensor(APP_UID, dtype=torch.int32,
                                               device=dev))
    cfg = RasterizeConfig(width=W, height=H, sh_degree=3, num_class=NUM_CLASS,
                          max_instances=cap, **DEFAULTS)
    bg = torch.zeros(3, device=dev)
    app_step = trainer.make_appearance_step(cfg, opt, 3, "L1_loss", True, bg,
                                            device=dev)
    app = app_lib.AppearanceOptimizer(APP_CAMERAS, device=dev)

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    s, history = (*state, app.params, app.opt_state), []
    for it in range(1, TRAIN_STEPS + 1):
        *s, m = app_step(*s, batch, lr_fn(it))
        history.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    check(all(launches[k] == TRAIN_STEPS for k in (
        "expand", "composite_forward_packed_quad",
        "composite_backward_packed_quad", "segment_sum", "ssim_forward",
        "ssim_backward"))
          and launches["composite_forward"] == 0
          and launches["composite_backward"] == 0,
          f"appearance (i.1): the steps did not launch K3, K1 and K2 in the "
          f"packed quad form, K4, K7 and K8 once each ({launches})")
    check(all(math.isfinite(h["loss"]) and not h["overflow"]
              for h in history), "appearance (i.1): a step failed")
    check(history[-1]["loss"] < history[0]["loss"],
          f"appearance (i.1): loss did not fall ({history[0]['loss']} -> "
          f"{history[-1]['loss']})")
    for name, tree in (("params", s[0]), ("mu", s[1].mu), ("nu", s[1].nu),
                       ("aux", s[2][1:]), ("appearance", s[3]),
                       ("appearance mu", s[4].mu),
                       ("appearance nu", s[4].nu)):
        check(all(bool(torch.isfinite(x).all()) for x in tree),
              f"appearance (i.1): non-finite {name}")
    check(int(s[4].count) == TRAIN_STEPS, "appearance (i.1): step count")
    moved = (s[3].emb != app.params.emb).any(dim=1).tolist()
    check(moved == [i == APP_UID for i in range(APP_CAMERAS)],
          f"appearance (i.1): embedding rows moved {moved}, expected only "
          f"row {APP_UID}")
    factors = [float(v) for v in app_lib.apply(s[3], batch["uid"],
                                                  batch["viewmatrix"])]
    print(f"appearance (i.1): {TRAIN_STEPS} steps, loss "
          f"{history[0]['loss']:.6f} -> {history[-1]['loss']:.6f}, l1 "
          f"{history[0]['l1']:.6f} -> {history[-1]['l1']:.6f}; factors "
          f"{json.dumps(factors)}; launches {json.dumps(launches)}")

    steps = {"default": trainer.make_train_step(
        cfg, opt, 3, "L1_loss", True, bg, device=dev),
        "appearance": lambda p, o, a, b, lrs: app_step(
            p, o, a, app.params, app.opt_state, b, lrs)}
    res = alternate_steps(torch, np, card, steps,
                          ("default", "appearance", "appearance", "default"),
                          state, batch, lr_fn(TRAIN_STEPS))
    busy = {k: v["busy"] for k, v in res.items()}
    extra = (None if None in busy.values()
             else busy["appearance"] - busy["default"])
    print(f"appearance (i.1) [{card}]: appearance step median "
          f"{res['appearance']['ms']:.3f} ms/step against the default "
          f"step's {res['default']['ms']:.3f}; device busy "
          f"{json.dumps(busy)} ms/step, the appearance's extra busy "
          f"{'not measured' if extra is None else f'{extra:.3f}'} ms/step; "
          f"phase {time.perf_counter() - t0:.1f} s")
    return launches


def sibr_message(np, cam, train, keep_alive):
    """A SIBR viewer's camera message for ``cam``, framed: the view matrix
    with columns 1 and 2 negated and the projection with column 1 negated,
    as the viewer sends them (``network_gui.receive`` negates them back)."""
    vm = np.array(cam.world_view_transform, np.float64)
    vm[:, 1:3] *= -1
    pm = np.array(cam.full_proj_transform, np.float64)
    pm[:, 1] *= -1
    payload = json.dumps({
        "resolution_x": cam.image_width, "resolution_y": cam.image_height,
        "train": train, "fov_y": cam.FoVy, "fov_x": cam.FoVx,
        "z_near": 0.01, "z_far": 100.0, "shs_python": False,
        "rot_scale_python": False, "keep_alive": keep_alive,
        "scaling_modifier": 1.0, "view_matrix": vm.ravel().tolist(),
        "view_projection_matrix": pm.ravel().tolist()}).encode("utf-8")
    return len(payload).to_bytes(4, "little") + payload


def socket_client(np, sock, cam, frames, errors):
    """The loopback viewer: SOCKET_FRAMES messages with ``train = False``,
    then one with ``train = True, keep_alive = False``; each reply (the
    frame, then the source path) read whole and kept with its round-trip
    ms.  Closes the socket whatever happens, so the server never waits on
    it."""
    n = cam.image_width * cam.image_height * 3

    def exactly(k):
        buf = bytearray()
        while len(buf) < k:
            chunk = sock.recv(min(k - len(buf), 1 << 22))
            if not chunk:
                raise ConnectionError("the server closed the connection")
            buf += chunk
        return bytes(buf)

    try:
        for i in range(SOCKET_FRAMES + 1):
            last = i == SOCKET_FRAMES
            t = time.perf_counter()
            sock.sendall(sibr_message(np, cam, last, not last))
            img = exactly(n)
            path = exactly(int.from_bytes(exactly(4), "little"))
            frames.append((img, path.decode("ascii"),
                           (time.perf_counter() - t) * 1e3))
    except Exception as e:  # noqa: BLE001  (reported by the phase)
        errors.append(repr(e))
    finally:
        sock.close()


def phase_appearance_trainer(torch, np, card, w, model, extent):
    """(i.2, i.3) ``Trainer(use_appearance=True, gui_source_path=...)`` on
    phase (c)'s cameras with exact cull and the default numerics,
    APP_TRAINER_ITERS iterations with one save and one checkpoint, while
    a loopback client on the port ``network_gui.init("127.0.0.1", 0)``
    bound asks for bench.py's camera (``socket_client``): every frame
    equal, byte for byte, to the quantised ``renderer.render`` of the
    model before the first iteration at the same camera, ``bg`` and
    ``max_instances``, K3 and K1 once per frame, training on to its last
    iteration; ``appearance_embedding.npz`` beside the PLY and
    ``appearance_chkpnt<it>.npz`` reloading equal.  Each exchange's
    server parts (``receive``, ``renderer.render``, ``frame_bytes``,
    ``send``) are clocked inside it, and ``frame_bytes``' readback and
    quantise apart after.  Returns the launch counts of the run."""
    import copy
    import socket
    import threading

    from gsplat_tpu_torch import _kernels, renderer
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.models.appearance import AppearanceOptimizer
    from gsplat_tpu_torch.scripts.render import quantize
    from gsplat_tpu_torch.train.trainer import Trainer
    from gsplat_tpu_torch.viz import network_gui
    t0 = time.perf_counter()
    dev = model.device
    cam = w.scene["cam"]
    tm = train_model(torch, model)
    cams = [target_camera(torch, np, renderer, tm, T, f"view{i}", i)
            for i, T in enumerate(TRAINER_POSES)]
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    tm.params = perturbed(torch, tm.params, model.capacity, gen)
    tm.training_setup()
    before = copy.deepcopy(tm)
    opt = OptimizationParams()
    opt.lambda_depth = TRAIN_LAMBDA_DEPTH
    opt.densify_from_iter = APP_TRAINER_ITERS      # no densification
    t_setup = time.perf_counter() - t0

    network_gui.init("127.0.0.1", 0)
    port = network_gui.listener.getsockname()[1]
    frames, errors, rows = [], [], []
    with tempfile.TemporaryDirectory() as out_dir:
        scene = MemoryScene(tm, cams[:4], cams[4:], extent, out_dir)
        tr = Trainer(tm, scene, opt, depth_loss_choice="L1_loss",
                     use_seg=True, cull="exact", max_instances=0,
                     model_path=out_dir, use_appearance=True,
                     gui_source_path=out_dir)

        def record(it, metrics, trainer):
            rows.append({"it": it, "loss": float(metrics["loss"]),
                         "overflow": bool(metrics["overflow"]),
                         "capacity": trainer.max_instances,
                         "launches": dict(_kernels.launch_counts)})

        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t1 = time.perf_counter()
        # the server's parts of each exchange, clocked where
        # poll_and_render calls them
        with clocked_calls(torch, network_gui, ("receive", "frame_bytes",
                                                "send")) as served, \
                clocked_calls(torch, renderer, ("render",)) as rendered, \
                socket.create_connection(("127.0.0.1", port),
                                         timeout=SOCKET_TIMEOUT) as sock:
            client = threading.Thread(
                target=socket_client, args=(np, sock, cam, frames, errors),
                daemon=True)
            client.start()
            tr.train(APP_TRAINER_ITERS, log_every=1, callback=record,
                     save_iterations={APP_TRAINER_ITERS},
                     checkpoint_iterations={APP_TRAINER_ITERS})
            client.join(SOCKET_TIMEOUT)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t1
        launches = dict(_kernels.launch_counts)
        check(not client.is_alive() and not errors,
              f"socket (i.3): the client failed: {errors}")
        check(network_gui.conn is None, "socket (i.3): the connection was "
              "not dropped after the client closed")
        network_gui.listener.close()
        network_gui.listener = None
        check([r["it"] for r in rows] == list(range(1, APP_TRAINER_ITERS
                                                     + 1)),
              "appearance (i.2): training did not go on to its last "
              "iteration")
        check(all(math.isfinite(r["loss"]) for r in rows),
              "appearance (i.2): non-finite loss")
        n_frames = SOCKET_FRAMES + 1
        first = rows[0]["launches"]
        check(first["composite_forward"] == n_frames
              and first["expand"] - first["expand_extras"] == n_frames,
              f"socket (i.3): {n_frames} frames did not launch K3 and K1 "
              f"once each ({first})")
        prev = first
        for r in rows[1:]:
            check(all(r["launches"][k] - prev[k] == 1 for k in CULL_KERNELS)
                  and r["launches"]["composite_forward"] == n_frames,
                  f"appearance (i.2): step {r['it']} did not launch K3x, "
                  f"K3, K1, K2, K4, K7 and K8 once each ({r['launches']})")
            prev = r["launches"]
        want = quantize(renderer.render(
            cam, before, bg_color=tr.bg, max_instances=rows[0]["capacity"],
            device=dev)["render"].cpu().numpy()).tobytes()
        check(len(frames) == n_frames, f"socket (i.3): {len(frames)} "
              f"frames received, {n_frames} asked for")
        for i, (img, path, _) in enumerate(frames):
            check(img == want, f"socket (i.3): frame {i} differs from the "
                  "quantised renderer.render of the model before training")
            check(path == out_dir, f"socket (i.3): frame {i} path {path!r}")
        served.update(rendered)
        check(all(len(v) == n_frames for v in served.values()),
              f"socket (i.3): clocked calls "
              f"{ {k: len(v) for k, v in served.items()} }, {n_frames} "
              "frames")

        app = tr.appearance
        emb = os.path.join(out_dir, "point_cloud",
                           f"iteration_{APP_TRAINER_ITERS}",
                           "appearance_embedding.npz")
        back = AppearanceOptimizer(1, device=dev)
        check(back.load(emb) and all(torch.equal(a, b) for a, b in zip(
            back.params, app.params)), "appearance (i.2): "
              "appearance_embedding.npz beside the PLY")
        ck = os.path.join(out_dir, f"appearance_chkpnt{APP_TRAINER_ITERS}"
                                   ".npz")
        check(back.load(ck), "appearance (i.2): no appearance checkpoint")
        for name, a, b in (("params", back.params, app.params),
                           ("mu", back.opt_state.mu, app.opt_state.mu),
                           ("nu", back.opt_state.nu, app.opt_state.nu)):
            check(all(torch.equal(x, y) for x, y in zip(a, b)),
                  f"appearance (i.2): checkpoint {name} differs")
        check(int(back.opt_state.count) == int(app.opt_state.count)
              == APP_TRAINER_ITERS, "appearance (i.2): checkpoint count")

    # frame_bytes' two parts at the same camera, timed apart (host clock
    # around synchronised work)
    apart = {"readback": [], "quantise": []}
    for _ in range(n_frames):
        img = renderer.render(cam, before, bg_color=tr.bg,
                              max_instances=rows[0]["capacity"],
                              device=dev)["render"]
        torch.cuda.synchronize()
        b = time.perf_counter()
        host = img.cpu().numpy()
        c = time.perf_counter()
        network_gui.frame_bytes(torch.from_numpy(host))
        d = time.perf_counter()
        apart["readback"].append((c - b) * 1e3)
        apart["quantise"].append((d - c) * 1e3)

    def warm(ms):
        """Median and p90 of the warmed frames (the first left out)."""
        return {"median": round(float(np.median(ms[1:])), 3),
                "p90": round(float(np.percentile(ms[1:], 90)), 3)}

    rt = [f[2] for f in frames]
    parts = {k: [x * 1e3 for x in v] for k, v in served.items()}
    parts["remainder"] = [t - parts["render"][i] - parts["frame_bytes"][i]
                          - parts["send"][i] for i, t in enumerate(rt)]
    print(f"socket (i.3) {W}x{H} [{card}]: {n_frames} frames bit-equal to "
          f"renderer.render, {len(frames[0][0])} bytes each; round trip "
          f"{json.dumps(warm(rt))} ms over the {n_frames - 1} warmed frames "
          f"(the first, cold, {rt[0]:.3f}); inside each exchange, "
          f"synchronised: "
          f"{json.dumps({k: warm(v) for k, v in parts.items()})} ms "
          f"(render: renderer.render; frame_bytes: readback and quantise; "
          f"send: three sendall; receive: the wait for and parse of the "
          f"client's next message; remainder: the round trip less render, "
          f"frame_bytes and send, not measured apart: the message's "
          f"transit and parse, the client's last reads, thread switches); "
          f"frame_bytes' parts alone "
          f"{json.dumps({k: warm(v) for k, v in apart.items()})} ms")
    print(f"appearance trainer (i.2) {W}x{H} [{card}]: {APP_TRAINER_ITERS} "
          f"iterations in {t_train:.1f} s with the socket frames, save and "
          f"checkpoint; capacity {rows[0]['capacity']}; loss "
          f"{rows[0]['loss']:.6f} -> {rows[-1]['loss']:.6f}; launches "
          f"{json.dumps(launches)}; setup {t_setup:.1f} s, phase "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def phase_appearance_cli(torch, np, card, work, device="cuda"):
    """(i.4) ``scripts.train.main`` on phase (d)'s scene with
    ``--able_appearance_embedding``, the viewer socket open (no
    ``--disable_gui_server``; ``--port 0``), then resumed from its
    checkpoint: the appearance checkpoint is loaded and carried on."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.models.appearance import AppearanceOptimizer
    from gsplat_tpu_torch.scripts import train as train_cli
    from gsplat_tpu_torch.viz import network_gui
    t0 = time.perf_counter()
    out = os.path.join(work, "cli_appearance")
    base = ["-s", os.path.join(work, "cli_scene"), "-m", out,
            "--data_device", device, "--able_appearance_embedding",
            "--port", "0",
            "--test_iterations", "99", "--densify_from_iter", "99"]
    counts = []
    for argv in (["--iterations_override", "10",
                  "--checkpoint_iterations", "10"],
                 ["--iterations_override", "15",
                  "--checkpoint_iterations", "15", "--start_checkpoint",
                  os.path.join(out, "chkpnt10.npz")]):
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        train_cli.main(base + argv)
        torch.cuda.synchronize()
        launches = dict(_kernels.launch_counts)
        check(network_gui.listener is not None
              and network_gui.listener.getsockname()[1] > 0,
              "appearance cli (i.4): the viewer socket was not opened")
        network_gui.listener.close()
        network_gui.listener = None
        app = AppearanceOptimizer(1, device=device)
        it = argv[1]
        check(app.load(os.path.join(out, f"appearance_chkpnt{it}.npz")),
              f"appearance cli (i.4): no appearance_chkpnt{it}.npz")
        counts.append(int(app.opt_state.count))
        check(launches["composite_backward_packed_quad"] > 0
              and launches["segment_sum"] > 0,
              f"appearance cli (i.4): launches {launches}")
    check(counts == [10, 15], f"appearance cli (i.4): appearance step "
          f"counts {counts}, expected [10, 15] (the resume loads "
          "appearance_chkpnt10.npz)")
    print(f"appearance cli (i.4) [{card}]: 10 iterations, then resumed to "
          f"15 from chkpnt10.npz with appearance_chkpnt10.npz; appearance "
          f"step counts {counts}; phase {time.perf_counter() - t0:.1f} s")


# (e) the kernel probes.  Every 17th tile of the asset (120 of 2,040,
# empty and full ones) is where each variant meets its plain version; P1's
# and P2's base meet K1 and K2 on the whole asset, bit for bit.
PROBE_SUBSET = 17
PROBE_KERNELS = ("probe_forward", "probe_backward", "probe_load",
                 "probe_dtype")
# P4 in bfloat16, on the tool's block (x = 0.3) and a seeded uniform one:
# the plain version rounds each operation to bf16 like the kernel, but takes
# exp through torch in float32 and rounds once, where h2exp rounds
# ex2.approx.f32 of x * log2(e); the two agreed on every element of both
# blocks on an H100, and one bf16 step of disagreement would move the sum
# by about one of its own steps: 2^-7 of the value.
P4_BF16_RTOL = 2.0 ** -7


def compare_packed(torch, got, want, C):
    """P1's (and compute_resident's) rule: each of the C channels and
    T_final within 3e-5 of max(1, the row's largest |value|) (K1's
    tolerance, tests/test_pallas_composite.py:35-43, scaled for the sums of
    the variants without termination), n_contrib exact.  Returns (max
    |diff| over the rows checked, pixels over tolerance)."""
    d = (got[:, :C + 1] - want[:, :C + 1]).abs()
    scale = torch.clamp(want[:, :C + 1].abs().amax(dim=(0, 2)), min=1.0)
    bad = int((d > 3e-5 * scale[None, :, None]).sum())
    bad += int((got[:, C + 1] != want[:, C + 1]).sum())
    return float(d.max()), bad


def compare_rows(torch, got, want):
    """P2's rule, K2's: each column within 1e-3 of its largest |value|.
    Returns (max |diff|, the worst column's diff over its scale)."""
    diff = (got - want).abs().amax(dim=0)
    scale = want.abs().amax(dim=0)
    worst = float(torch.where(scale > 0, diff / torch.where(
        scale > 0, scale, 1.0), torch.where(diff > 0, float("inf"), 0.0))
        .max())
    return float(diff.max()), worst


def phase_probes(torch, card, w):
    """(e) The kernel probes of ``gsplat_tpu_torch.tools`` at the asset: P1
    and P2 ``base`` bit-equal to K1 and K2; every variant of P1 to P4
    against its plain version; then the six entry modules with the launch
    counts zeroed just before (each of P1 to P4 launched), which time every
    variant.  Returns the kernel table's rows for P1 to P4."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.ops import composite_cuda as comp
    from gsplat_tpu_torch.tools import (bench_bwd_attrib, bench_dma_overhead,
                                        bench_fwd_attrib,
                                        bench_inkernel_gather, bench_kernels,
                                        bench_vpu_dtype, probes)
    from gsplat_tpu_torch.tools import workload as wl
    t0 = time.perf_counter()
    dev = w.table.device
    C = w.C
    check(bits_equal(torch, probes.probe_forward("base", *w.k1_args),
                     comp.composite_forward(*w.k1_args)),
          "P1: base is not bit-equal to K1")
    check(bits_equal(torch, probes.probe_backward("base", *w.k2_args),
                     comp.composite_backward(*w.k2_args)),
          "P2: base is not bit-equal to K2")
    keep = torch.arange(w.counts.shape[0], device=dev) % PROBE_SUBSET == 0
    cnt = torch.where(keep, w.counts, 0).to(torch.int32)
    sub1 = (w.table, w.gauss_id, w.starts, cnt, w.grid_x)
    sub2 = (*sub1, w.packed, w.d_packed, w.Cg)
    errs = {k: 0.0 for k in ("P1", "P2", "P3", "P4")}
    lines = []
    for v in probes.FWD_VARIANTS:
        err, bad = compare_packed(torch, probes.probe_forward(v, *sub1),
                                  probes.probe_forward_plain(v, *sub1), C)
        check(bad == 0, f"P1 {v}: {bad} values outside tolerance")
        errs["P1"] = max(errs["P1"], err)
        lines.append(f"P1 {v} {err:.3g}")
    for v in probes.BWD_VARIANTS:
        err, worst = compare_rows(torch, probes.probe_backward(v, *sub2),
                                  probes.probe_backward_plain(v, *sub2))
        check(worst <= 1e-3, f"P2 {v}: a column differs by {worst:.3g} of "
              "its largest value")
        errs["P2"] = max(errs["P2"], err)
        lines.append(f"P2 {v} {err:.3g} ({worst:.2g} of the column)")
    limits = w.pairs["limits"]
    for v in probes.LOAD_VARIANTS:
        got = probes.probe_load(v, *sub1, limits=limits)
        want = probes.probe_load_plain(v, *sub1, limits=limits)
        if v == "compute_resident":
            err, bad = compare_packed(torch, got, want, C)
            check(bad == 0, f"P3 {v}: {bad} values outside tolerance")
        else:
            err = float((got - want).abs().max())
            check(torch.equal(got, want), f"P3 {v}: differs from its plain "
                  "version (the same adds in the same order)")
        errs["P3"] = max(errs["P3"], err)
        lines.append(f"P3 {v} {err:.3g}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t128 = torch.randn((w.table.shape[0], 128), generator=gen, device=dev)
    for src in (w.table, t128):             # ids include the pad sentinel
        got = probes.probe_gather("row_gather", src, w.gauss_id)
        check(torch.equal(got, probes.probe_gather_plain(
            "row_gather", src, w.gauss_id)), "P3 row_gather differs")
        check(torch.equal(probes.probe_gather("block_copy", got), got),
              "P3 block_copy differs")
    lines.append("P3 row_gather, block_copy exact at R = 13 and 128")
    gen.manual_seed(4)
    u = torch.rand(bench_vpu_dtype.SHAPE, generator=gen, device=dev)
    for x in (*bench_vpu_dtype.inputs(dev).values(), u, u.bfloat16()):
        got = probes.probe_dtype(x, bench_vpu_dtype.N_PROGRAMS,
                                 bench_vpu_dtype.N_ITERS).float()
        want = probes.probe_dtype_plain(x, bench_vpu_dtype.N_ITERS).float()
        rel = float(((got - want).abs() / want.abs()).max())
        tol = P4_BF16_RTOL if x.dtype == torch.bfloat16 else 1e-6
        check(rel <= tol, f"P4 {x.dtype}: relative diff {rel:.3g} over {tol}")
        errs["P4"] = max(errs["P4"], float((got - want).abs().max()))
        lines.append(f"P4 {x.dtype} relative {rel:.3g} (tolerance {tol:.3g})")
    print("probes (e): P1 base and P2 base bit-equal to K1 and K2 at the "
          f"asset; against the plain versions on {int(keep.sum())} tiles, "
          "max |diff|: " + "; ".join(lines))
    stats = wl.pair_stats(w)
    print(f"probes (e): pairs {json.dumps({k: v for k, v in stats.items() if k != 'limits'})}")

    # the entry modules, as a user runs them, counted
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    fwd = bench_fwd_attrib.main(workload=w, stats=stats)
    bwd = bench_bwd_attrib.main(workload=w, stats=stats)
    kfwd, _, _ = bench_kernels.main(workload=w, stats=stats)
    dma = bench_dma_overhead.main(workload=w, stats=stats)
    gather = bench_inkernel_gather.main(workload=w)
    dtype = bench_vpu_dtype.main()
    torch.cuda.synchronize()
    launches = {k: _kernels.launch_counts[k] for k in PROBE_KERNELS}
    print(f"probes (e): launches {json.dumps(launches)}")
    check(all(n > 0 for n in launches.values()),
          "probes: a probe kernel was not launched by the entry modules")

    def variants(rows):
        return {r["name"]: {k: r[k] for k in ("ms", "share", "bound_ms",
                                              "bound_by", "launches")
                            if k in r} for r in rows}

    p1 = variants(fwd)
    p1.update({k: v for k, v in variants(kfwd).items() if k not in p1})
    (l128, g128), (lprod, gprod) = gather
    p3 = variants(dma)
    for label, rows in ((l128, g128), (lprod, gprod)):
        p3.update({f"{r['name']} {label}": v for r, v in zip(
            rows, variants(rows).values())})
    g = {r["name"]: r for r in gprod}
    _, t13, ids = bench_inkernel_gather.tables(w, dev)[1]
    x32 = bench_vpu_dtype.inputs(dev)["f32"]
    plain = {
        "P1": single_ms(torch, lambda: probes.probe_forward_plain(
            "base", *w.k1_args))[0],
        "P2": single_ms(torch, lambda: probes.probe_backward_plain(
            "base", *w.k2_args))[0],
        "P3": event_ms(lambda: probes.probe_gather_plain(
            "row_gather", t13, ids), 5),
        "P4": event_ms(lambda: probes.probe_dtype_plain(
            x32, bench_vpu_dtype.N_ITERS), 5),
    }
    print(f"probes (e) [{card}]: plain versions {json.dumps(plain)} ms; "
          f"phase {time.perf_counter() - t0:.1f} s")

    def row(name, source, replaces, counter, r, err, plain_ms, library_ms,
            var):
        return {"name": name, "route": "cuda",
                "source": f"gsplat_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[counter],
                "max_abs_err": err, "ms": r["ms"], "plain_ms": plain_ms,
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": library_ms, "variants": var}

    return [
        row("P1 probe_forward (base)", "probe_fwd.cu",
            "tools/bench_fwd_attrib.py:35", "probe_forward", fwd[0],
            errs["P1"], plain["P1"], None, p1),
        row("P2 probe_backward (base)", "probe_bwd.cu",
            "tools/bench_bwd_attrib.py:49", "probe_backward", bwd[0],
            errs["P2"], plain["P2"], None, variants(bwd)),
        row(f"P3 probe_load (row_gather {lprod})", "probe_load.cu",
            "tools/bench_inkernel_gather.py:46", "probe_load",
            g["row_gather"], errs["P3"], plain["P3"],
            g["index_select"]["ms"], p3),
        row("P4 probe_dtype (f32)", "probe_dtype.cu",
            "tools/bench_vpu_dtype.py:23", "probe_dtype", dtype[0],
            errs["P4"], plain["P4"], None, variants(dtype)),
    ]


# (f) the JAX trainer's default numerics: the forms of K1 and K2.  Each
# form's kernels meet their plain versions at the asset; the main path runs
# ten make_train_step steps in the JAX Trainer's configuration, one step of
# each form alone, and bench.py's serving configuration.
FORMS = ("quad", "packed", "packed_quad")
# the JAX Trainer's numerics (gsplat_tpu/train/trainer.py:252-254, 384)
DEFAULTS = dict(grad_precision="bf16", feat_precision="bf16", mxu_power=True)
# the single forms' steps
FORM_CONFIGS = {"quad": dict(mxu_power=True),
                "packed": dict(grad_precision="bf16", feat_precision="bf16")}


def phase_form_kernels(torch, card, w):
    """Each form of K1 and K2 against its plain version at the asset (K1's
    inputs in the form's table layout, K2 on that form's K1 output and the
    asset's seeded cotangent); their times, plain times and bounds."""
    from gsplat_tpu_torch.ops import composite_cuda as comp
    from gsplat_tpu_torch.tools import workload as wl
    t0 = time.perf_counter()
    C, Cg = w.C, w.Cg
    gid, starts, counts, gx = w.gauss_id, w.starts, w.counts, w.grid_x
    T = starts.shape[0]
    rows = {}
    quad_culled = None
    for name in FORMS:
        form = wl.form_of(name)
        table = wl.form_table(w.table, Cg, form)
        k1 = (table, gid, starts, counts, gx, form, Cg)
        out_k = comp.composite_forward(*k1)
        plain_ms, out_p = single_ms(torch, lambda: comp.composite_forward_plain(
            *k1))
        err1, over, nc_diff = compare_k1(comp, out_k, out_p, C)
        check(sum(over.values()) == 0 and nc_diff == 0,
              f"K1 {name}: kernel disagrees with its plain version "
              f"({json.dumps(over)}, n_contrib at {nc_diff} pixels)")
        check(bool(torch.isfinite(out_k).all()), f"K1 {name}: non-finite")
        if not form.mxu_power:
            # the features do not reach T_final or n_contrib: the f32 form's
            check(bits_equal(torch, out_k[:, C:], w.packed[:, C:]),
                  f"K1 {name}: T_final or n_contrib differs from the f32 form")
        ms1 = event_ms(lambda: comp.composite_forward(*k1), 20)
        bits = form.bits | (4 if form.with_ones else 0)
        cg = Cg if form.feat_packed else C
        occ1 = (f"{comp.forward_occupancy(C, cg, form)} CTAs per SM, "
                f"{k1_ptxas(C, bits)}")
        # the quad forms' walk (their features do not reach n_contrib)
        if form.mxu_power and quad_culled is None:
            quad_culled = wl.k1_culled_pairs(*w.k1_args, out_k[:, C + 1],
                                             quad=True)
        culled = quad_culled if form.mxu_power else w.culled
        test_ops = wl.K1_TEST_OPS - int(form.mxu_power)   # P1 quad_power's
        ops1 = wl.k1_ops(culled, C, test_ops=test_ops, quad=form.mxu_power,
                         unpack=Cg if form.feat_packed else 0)
        bytes1 = (table.numel() * 4 + int(counts.sum()) * 4 + 2 * 4 * T
                  + out_k.numel() * 4)
        bound1, by1 = wl.bound_ms(bytes1, ops1, nexp=culled["live"])
        rows[f"K1 {name}"] = {
            "max_abs_err": err1, "ms": ms1, "plain_ms": plain_ms,
            "bound_ms": bound1, "bound_by": by1, "library_ms": None}

        k2 = (table, gid, starts, counts, gx, out_k, w.d_packed, Cg, form)
        d_k = comp.composite_backward(*k2)
        torch.cuda.synchronize()
        plain2_ms, d_p = single_ms(torch, lambda: comp.composite_backward_plain(
            *k2))
        check(bool(torch.isfinite(d_k[:, :6]).all()),
              f"K2 {name}: non-finite gradient row")
        check(float(d_k[gid >= table.shape[0]].abs().max()) == 0.0,
              f"K2 {name}: pad slots carry gradient")
        err2, worst, bad = wl.compare_form_rows(d_k, d_p, Cg,
                                                form.feat_packed)
        check(bad == 0, f"K2 {name}: {bad} values outside tolerance (worst "
              f"column {worst:.3g} of its largest)")
        check(torch.equal(comp.composite_backward(*k2), d_k),
              f"K2 {name}: two launches gave different bits")
        ms2 = event_ms(lambda: comp.composite_backward(*k2), 10)
        nc = out_k[:, C + 1]
        limit = torch.minimum(nc.amax(dim=1).long(), counts.long())
        staged, n_real = wl.staged_instances(w, limit)
        tested2 = int(nc.sum())
        ops2 = ((wl.K2_TEST_OPS - int(form.mxu_power)) * tested2
                + wl.k2_pair_ops(C, Cg) * culled["composited"])
        if form.feat_packed:
            ops2 += (wl.UNPACK_OPS * Cg * n_real
                     + wl.PACK_OPS * ((Cg + 1) // 2) * staged)
        bytes2 = (table.numel() * 4 + int(counts.sum()) * 4 + 2 * 4 * T
                  + 2 * out_k.numel() * 4 + d_k.numel() * 4)
        bound2, by2 = wl.bound_ms(bytes2, ops2, nexp=tested2)
        rows[f"K2 {name}"] = {
            "max_abs_err": err2, "ms": ms2, "plain_ms": plain2_ms,
            "bound_ms": bound2, "bound_by": by2, "library_ms": None}
        print(f"forms (f) [{card}] {name}: K1 vs plain max |diff| {err1:.3g}"
              f", n_contrib equal; {occ1}; {ms1:.4f} ms (plain "
              f"{plain_ms:.1f} ms), "
              f"bound {bound1:.4f} ms ({by1}; {bytes1} bytes, {ops1} ops; "
              f"pairs "
              f"{culled['live']} live after the cull, "
              f"{culled['composited']} composited)"
              f"; K2 vs plain max |diff| {err2:.3g} (worst column "
              f"{worst:.2e} of its largest), {ms2:.4f} ms (plain "
              f"{plain2_ms:.1f} ms), bound {bound2:.4f} ms ({by2}; {bytes2} "
              f"bytes, {ops2} ops, {tested2} exponentials)")
    print(f"forms (f): kernels phase {time.perf_counter() - t0:.1f} s")
    return rows


def phase_form_paths(torch, np, card, w):
    """The main path in the forms: ten ``make_train_step`` steps in the
    JAX Trainer's configuration (finite state, falling loss), steps in it
    and in f32 alternated from one state (f32, default, default, f32) with
    ms/step, device busy and idle share; one step in each single form; and
    bench.py's serving configuration (``render_only=True,
    feat_precision="bf16"``) at 1080p.  Returns the launch counts: the ten
    default steps', each single-form step's, and the served frame's."""
    from gsplat_tpu_torch import _kernels, renderer
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    from gsplat_tpu_torch.train import trainer
    t0 = time.perf_counter()
    sc = w.scene
    model, cam, cap = sc["model"], sc["cam"], sc["cap"]
    dev = model.device
    ti = train_inputs(torch, cam, model, cap)
    batch, state, opt, lr_fn = (ti[k] for k in ("batch", "state", "opt",
                                                 "lr_fn"))

    def make_step(kw):
        cfg = RasterizeConfig(width=W, height=H, sh_degree=3,
                              num_class=NUM_CLASS, max_instances=cap, **kw)
        return trainer.make_train_step(cfg, opt, 3, "L1_loss", True,
                                       torch.zeros(3, device=dev), device=dev)

    steps = {"f32": make_step({}), "default": make_step(DEFAULTS)}
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    s, history = state, []
    for it in range(1, TRAIN_STEPS + 1):
        *s, m = steps["default"](*s, batch, lr_fn(it))
        history.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = {"packed_quad": dict(_kernels.launch_counts)}
    check(all(launches["packed_quad"][k] == TRAIN_STEPS for k in (
        "expand", "composite_forward_packed_quad",
        "composite_backward_packed_quad", "segment_sum", "ssim_forward",
        "ssim_backward"))
          and launches["packed_quad"]["composite_forward"] == 0
          and launches["packed_quad"]["composite_backward"] == 0,
          f"forms (f): the default steps did not launch K3, K1 and K2 in "
          f"the packed quad form, K4, K7 and K8 once each ({launches})")
    check(all(math.isfinite(h["loss"]) and not h["overflow"]
              for h in history), "forms (f): a default step failed")
    check(history[-1]["loss"] < history[0]["loss"]
          and history[-1]["l1"] < history[0]["l1"],
          f"forms (f): loss did not fall ({history[0]['loss']} -> "
          f"{history[-1]['loss']})")
    for name, tree in (("params", s[0]), ("mu", s[1].mu), ("nu", s[1].nu),
                       ("aux", s[2][1:])):
        check(all(bool(torch.isfinite(x).all()) for x in tree),
              f"forms (f): non-finite {name} after the default steps")
    print(f"forms (f): {TRAIN_STEPS} default steps, loss "
          f"{history[0]['loss']:.6f} -> {history[-1]['loss']:.6f}, l1 "
          f"{history[0]['l1']:.6f} -> {history[-1]['l1']:.6f}, launches "
          f"{json.dumps(launches['packed_quad'])}")

    # f32 and default alternated from one state
    lrs = lr_fn(TRAIN_STEPS)
    alternate_steps(torch, np, card, steps, ("f32", "default", "default",
                                             "f32"), state, batch, lrs)

    # one step in each single form, counted
    for name in ("quad", "packed"):
        step = make_step(FORM_CONFIGS[name])
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        m = step(*state, batch, lrs)[3]
        torch.cuda.synchronize()
        launches[name] = dict(_kernels.launch_counts)
        check(launches[name][f"composite_forward_{name}"] == 1
              and launches[name][f"composite_backward_{name}"] == 1
              and math.isfinite(float(m["loss"])),
              f"forms (f): the {name} step ({launches[name]})")

    # bench.py's serving configuration at 1080p
    p = model.params
    cfg_r = RasterizeConfig(width=W, height=H, sh_degree=3, max_instances=cap,
                            render_only=True, feat_precision="bf16")
    args = (p.xyz, T.scaling_activation(p.scaling), p.rotation,
            T.opacity_activation(p.opacity[:, 0]), model.get_features)
    cam_kw = dict(viewmatrix=cam.world_view_transform,
                  projmatrix=cam.full_proj_transform,
                  campos=cam.camera_center, tan_fovx=cam.tan_fovx,
                  tan_fovy=cam.tan_fovy, bg=torch.zeros(3, device=dev),
                  device=dev)

    def serve():
        return rasterize(cfg_r, *args, **cam_kw)

    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = serve()
    torch.cuda.synchronize()
    launches["serving"] = dict(_kernels.launch_counts)
    check(launches["serving"]["composite_forward_packed"] == 1
          and launches["serving"]["expand"] == 1,
          f"forms (f): serving did not launch K3 and packed K1 once "
          f"({launches['serving']})")
    check(not bool(out["overflow"]) and out["render"].shape == (3, H, W)
          and bool(torch.isfinite(out["render"]).all()),
          "forms (f): serving output")
    ref = renderer.render(cam, model, device=dev)["render"]
    rgb_err = float((out["render"] - ref).abs().max())
    # features rounded to bf16 (2^-9 relative) in an image of values <= ~1
    check(rgb_err <= 6e-3, f"forms (f): served frame differs from the f32 "
          f"render by {rgb_err}")
    for _ in range(3):
        serve()
    torch.cuda.synchronize()
    ft = []
    for _ in range(30):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        serve()
        b.record()
        torch.cuda.synchronize()
        ft.append(a.elapsed_time(b))
    med = float(np.median(ft))
    busy = profile_window(torch, serve, 10, "frame (serving)", med, card)
    print(f"forms (f) serving render_only feat bf16 {W}x{H} [{card}]: median "
          f"{med:.3f} ms/frame (p10 {np.percentile(ft, 10):.3f}, p90 "
          f"{np.percentile(ft, 90):.3f}), device busy "
          f"{'not measured' if busy is None else f'{busy:.3f}'} ms/frame; "
          f"max |diff| against the f32 render {rgb_err:.3g}; launches "
          f"{json.dumps(launches['serving'])}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return launches


def form_rows(rows, launches):
    """The kernel table's rows of the forms: launches from the main path
    (the default steps for the packed quad forms, each single form's step,
    the served frame for K1's packed form)."""
    out = []
    for name in FORMS:
        for k, kind, src, line in (
                ("K1", "forward", "composite_fwd_forms.cu", 247),
                ("K2", "backward", "composite_bwd_forms.cu", 356)):
            run = ("serving" if (k, name) == ("K1", "packed") else name)
            opts = {"quad": "mxu_power", "packed": "feat_precision=bf16",
                    "packed_quad": "feat_precision=bf16, mxu_power"}[name]
            out.append({
                "name": f"{k} composite_{kind}_{name}", "route": "cuda",
                "source": f"gsplat_tpu_torch/csrc/{src}",
                "replaces": f"gsplat_tpu/ops/composite_pallas.py:{line} "
                            f"({opts})",
                "launches": launches[run][f"composite_{kind}_{name}"],
                **rows[f"{k} {name}"]})
    return out


# (g) K1 and K2 at other tile shapes, each in a fresh interpreter: 16x16,
# and 9x9, where a thread's four pixels cross a row and the last thread's
# reach past the tile (K1's row-crossing kernel; K2 takes tiles of whole
# warps only, so K1 alone)
TILE_SHAPES = ((16, 16), (9, 9))
# the shapes at which main checks the warp map (blocks, row-major, rows that
# cross, a last thread past the tile)
WARP_MAP_SHAPES = ((32, 32), (16, 16), (48, 16), (8, 8), (9, 9), (10, 10),
                   (6, 16), (5, 5))
TILE_GAUSSIANS, TILE_SIZE, TILE_TIMEOUT = 4000, 256, 120


def start_tile_child(tx, ty):
    """This script with ``--tile TXxTY`` under tiles of that shape, started
    once the kernels are built: it imports and reaches the card while the
    phases before (g) run, then waits for a line on its stdin, so that its
    kernels run alone (``phase_tiles``).  It is killed if this process
    exits first; on its own it exits when its stdin closes."""
    env = dict(os.environ, GSPLAT_TILE_X=str(tx), GSPLAT_TILE_Y=str(ty))
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tile", f"{tx}x{ty}"],
        env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    atexit.register(lambda: child.poll() is None and child.kill())
    return child


def phase_tiles(card, children):
    """Lets each tile-shape child run in turn and checks it said so."""
    for (tx, ty), child in children.items():
        t0 = time.perf_counter()
        out, err = child.communicate("go\n", timeout=TILE_TIMEOUT)
        sys.stdout.write(out)
        sys.stderr.write(err[-4000:])
        tag = f"tile{tx}x{ty} (g)"
        check(child.returncode == 0 and f"{tag}: ok" in out,
              f"the {tx}x{ty} phase failed (exit {child.returncode})")
        print(f"{tag} [{card}]: phase {time.perf_counter() - t0:.1f} s (the "
              "child's start overlapped the phases before)")


def tile_main(tx, ty):
    """(g) K1, and where the tile is whole warps K2, in each form at tiles
    of tx x ty against their plain versions, on a seeded 256x256 scene: C =
    7 channels as the asset's (rgb, depth, two segments, ones; Cg = 6), a
    cotangent from a generator seeded 3; and the warp map's check at the
    shape."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.core.cameras import Camera
    from gsplat_tpu_torch.models.gaussians import params_from_numpy
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.ops import binning as bin_lib
    from gsplat_tpu_torch.ops import composite_cuda as comp
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    from gsplat_tpu_torch.tools import workload as wl
    tag = f"tile{tx}x{ty}"
    check((pre_lib.TILE_X, pre_lib.TILE_Y) == (tx, ty)
          and comp.TILE_PIX == tx * ty,
          f"{tag}: GSPLAT_TILE_X/Y did not reach the port")
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    _kernels.lib()
    if sys.stdin.readline().strip() != "go":
        return 3
    t0 = time.perf_counter()
    wmap = comp.warp_map_errors(tx, ty)
    check(wmap == {"outside": 0, "misowned": 0},
          f"{tag}: the warp map and the cull's boxes disagree: {wmap}")
    n, S = TILE_GAUSSIANS, TILE_SIZE
    rng = np.random.default_rng(16)
    model = params_from_numpy(dict(
        xyz=rng.standard_normal((n, 3)) * 1.2,
        features_dc=rng.standard_normal((n, 1, 3)) * 0.8,
        features_rest=rng.standard_normal((n, 15, 3)) * 0.2,
        scaling=rng.standard_normal((n, 3)) * 0.5 - 2.5,
        rotation=rng.standard_normal((n, 4)),
        opacity=rng.standard_normal((n, 1)) * 1.5,
        segment=rng.standard_normal((n, NUM_CLASS))), device=dev)
    cam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                 FoVx=math.radians(60.0), FoVy=math.radians(60.0),
                 image=np.zeros((3, S, S), np.float32), image_name="tile",
                 uid=0)
    p = model.params
    pre = pre_lib.preprocess(
        p.xyz, T.scaling_activation(p.scaling), p.rotation,
        T.opacity_activation(p.opacity[:, 0]), model.get_features, 3,
        *[torch.as_tensor(m, device=dev) for m in (
            cam.world_view_transform, cam.full_proj_transform,
            cam.camera_center)], cam.tan_fovx, cam.tan_fovy, S, S)
    gx, gy = (S + tx - 1) // tx, (S + ty - 1) // ty
    bins = bin_lib.bin_gaussians(pre, gx, gy, 1 << 19)
    check(not bool(bins.overflow), f"{tag}: binning overflowed")
    feats = torch.cat([pre.rgb, pre.depths[:, None],
                       T.segment_activation(p.segment),
                       torch.ones_like(pre.depths[:, None])], dim=1)
    table = torch.cat([pre.means2d, pre.conic, pre.opacity[:, None], feats],
                      dim=1).contiguous()
    C, Cg = feats.shape[1], feats.shape[1] - 1
    starts, counts = comp.tile_ranges(bins)
    gid = bins.gauss_id.contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    d_packed = torch.randn((gx * gy, C + 2, comp.TILE_PIX), generator=gen,
                           device=dev)
    with_k2 = comp.TILE_PIX % 32 == 0
    lines = []
    for name in ("f32", *FORMS):
        form = wl.form_of(name)
        tab = wl.form_table(table, Cg, form)
        out = comp.composite_forward(tab, gid, starts, counts, gx, form, Cg)
        out_p = comp.composite_forward_plain(tab, gid, starts, counts, gx,
                                             form, Cg)
        err1, over, nc_diff = compare_k1(comp, out, out_p, C, S, S)
        check(sum(over.values()) == 0 and nc_diff == 0
              and bool(torch.isfinite(out).all()),
              f"{tag} K1 {name}: kernel disagrees with its plain version "
              f"({json.dumps(over)}, n_contrib at {nc_diff} pixels)")
        line = f"{name} K1 max |diff| {err1:.3g}, n_contrib equal"
        if with_k2:
            k2 = (tab, gid, starts, counts, gx, out, d_packed, Cg, form)
            d_k = comp.composite_backward(*k2)
            d_p = comp.composite_backward_plain(*k2)
            check(bool(torch.isfinite(d_k[:, :6]).all()),
                  f"{tag} K2 {name}: non-finite gradient row")
            check(float(d_k[gid >= tab.shape[0]].abs().max()) == 0.0,
                  f"{tag} K2 {name}: pad slots carry gradient")
            err, worst, bad = wl.compare_form_rows(d_k, d_p, Cg,
                                                   form.feat_packed)
            check(bad == 0, f"{tag} K2 {name}: {bad} values outside "
                  f"tolerance (worst column {worst:.3g} of its largest)")
            check(torch.equal(comp.composite_backward(*k2), d_k),
                  f"{tag} K2 {name}: two launches gave different bits")
            line += (f"; K2 max |diff| {err:.3g} (worst column {worst:.2e} "
                     "of its largest), rows written "
                     f"{int((d_k != 0).any(dim=1).sum())}")
        lines.append(line)
    print(f"{tag} (g): {n} gaussians at {S}x{S}, {gx * gy} tiles of "
          f"{tx}x{ty}, {int(bins.num_rendered)} instances; warp map sound; "
          f"K1{' and K2' if with_k2 else ''} against the plain versions: "
          + "; ".join(lines))
    print(f"{tag} (g): ok in {time.perf_counter() - t0:.1f} s")
    return 0


def k1_occupancy(comp):
    """K1's CTAs per SM at this tile shape, as ``k2_occupancy`` asks K2's:
    f32 at C = 3, 5, 7 and 9 (its runtime-C kernel), the packed quad form
    at C = 3 (without the ones channel), 5, 7 and 4 (its runtime-C
    kernel)."""
    from gsplat_tpu_torch.tools import workload as wl
    quad = wl.form_of("packed_quad")
    out = {f"f32 C={C}": comp.forward_occupancy(C, C) for C in (3, 5, 7, 9)}
    out["packed_quad C=3"] = comp.forward_occupancy(
        3, 3, quad._replace(with_ones=False))
    out.update({f"packed_quad C={C}": comp.forward_occupancy(C, C - 1, quad)
                for C in (5, 7, 4)})
    return out


def k2_occupancy(comp):
    """K2's CTAs per SM at this tile shape, f32 at C = 3, 5, 7 and 9 (its
    runtime-C kernel) and the packed quad form at C = 3, 5, 7 and 4 (its
    runtime-C kernel), Cg = C - 1."""
    from gsplat_tpu_torch.tools import workload as wl
    quad = wl.form_of("packed_quad")
    return {f"{name} C={C}": comp.backward_occupancy(C, C - 1, form)
            for name, form, cs in (("f32", comp.F32, (3, 5, 7, 9)),
                                   ("packed_quad", quad, (3, 5, 7, 4)))
            for C in cs}


# (j) multi-GPU training and rendering (gsplat_tpu_torch/parallel) on the
# one card: bench.py's camera made at 1920x1152 (36 tile rows, so D = 2
# and D = 4 split it; fovy from bench.py's formula, so the focal length is
# the 1080p camera's), the data-parallel step at world size 1 over NCCL,
# two gloo ranks sharing the card, the training CLI's --multihost.
PAR_H = 1152
PAR_SLICES = (2, 4)
PAR_RANKS = 2
PAR_TIMEOUT = 600


def par_camera(np, pose, uid):
    """bench.py's camera at ``pose`` and W x PAR_H."""
    from gsplat_tpu_torch.core.cameras import Camera
    fovx = math.radians(62.0)
    fovy = 2 * math.atan(math.tan(fovx / 2) * PAR_H / W)
    return Camera(colmap_id=uid, R=np.eye(3), T=np.array(pose), FoVx=fovx,
                  FoVy=fovy, image=np.zeros((3, PAR_H, W), np.float32),
                  image_name=f"par{uid}", uid=uid)


def par_inputs(torch, np, model):
    """What (j.3) starts from, the same in each rank and in this process:
    the asset in TRAIN_CAPACITY slots with parameters perturbed by noise
    from a generator seeded 7 (cold Adam moments), the first PAR_RANKS of
    TRAINER_POSES at W x PAR_H with targets rendered from the unperturbed
    asset, the f32 config at the capacity the renderer measures for camera
    0, the optimization params and the learning rates."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.train import schedules, trainer
    dev = model.device
    tm = train_model(torch, model)
    cams = [par_camera(np, TRAINER_POSES[i], i) for i in range(PAR_RANKS)]
    cap = renderer._auto_capacity(cams[0], tm, W, PAR_H, 1.0)
    batches = []
    for c in cams:
        target = renderer.render(c, tm, max_instances=cap, device=dev)
        check(not bool(target["overflow"]), "(j) target render overflowed")
        b = trainer.camera_batch(
            c, gt_depth=target["depth_raw"][None],
            gt_seg=torch.argmax(target["segment"], dim=0), device=dev)
        b["gt_image"] = target["render"]
        batches.append(b)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    state = (perturbed(torch, tm.params, model.capacity, gen), tm.opt_state,
             tm.aux)
    opt = OptimizationParams()
    opt.lambda_depth = TRAIN_LAMBDA_DEPTH
    cfg = RasterizeConfig(width=W, height=PAR_H, sh_degree=3,
                          num_class=NUM_CLASS, max_instances=cap)
    return dict(batches=batches, state=state, opt=opt, cfg=cfg,
                lrs=schedules.make_lr_fn(opt, 1.0)(1))


def phase_par_slices(torch, np, card, model):
    """(j.1) The asset at W x PAR_H rendered in D row slices one after
    another through ``tile_parallel.render_slice`` (each rank's function)
    and concatenated, for each D of PAR_SLICES: bit-equal to the full
    render at that camera, the slices' radii's maximum equal to the full
    radii; K3 and K1 once per slice, and each slice's ms."""
    from gsplat_tpu_torch import _kernels, renderer
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    from gsplat_tpu_torch.parallel.tile_parallel import (render_slice,
                                                         slice_camera)
    t0 = time.perf_counter()
    dev = model.device
    cam = par_camera(np, TRAINER_POSES[0], 0)
    cap = renderer._auto_capacity(cam, model, W, PAR_H, 1.0)
    cfg = RasterizeConfig(width=W, height=PAR_H, sh_degree=3,
                          num_class=NUM_CLASS, max_instances=cap)
    p = model.params
    args = (p.xyz, T.scaling_activation(p.scaling), p.rotation,
            T.opacity_activation(p.opacity[:, 0]), model.get_features)
    segs = T.segment_activation(p.segment)
    camd = slice_camera(cam, 1, device=dev)
    bg = torch.tensor([0.15, 0.3, 0.1], device=dev)
    full = rasterize(cfg, *args, **camd, bg=bg, segments=segs, device=dev)
    check(not bool(full["overflow"]), "(j.1) full render overflowed")
    full_ms = event_ms(lambda: rasterize(cfg, *args, **camd, bg=bg,
                                         segments=segs, device=dev), 10)
    for D in PAR_SLICES:
        outs, launches, ms = [], [], []
        for r in range(D):
            torch.cuda.synchronize()
            _kernels.reset_launch_counts()
            outs.append(render_slice(cfg, D, r, *args, camd, bg,
                                     segments=segs, device=dev))
            torch.cuda.synchronize()
            launches.append({k: v for k, v in _kernels.launch_counts.items()
                             if v})
            ms.append(event_ms(lambda: render_slice(
                cfg, D, r, *args, camd, bg, segments=segs, device=dev), 10))
        check(all(n == {"preprocess_forward": 1, "expand": 1,
                        "composite_forward": 1} for n in launches),
              f"(j.1) D={D}: a slice did not launch K5, K3 and K1 once each "
              f"({launches})")
        check(not any(bool(o["overflow"]) for o in outs),
              f"(j.1) D={D}: a slice overflowed")
        for k in ("render", "depth", "alpha", "segment", "T_final"):
            got = torch.cat([o[k] for o in outs], dim=-2)
            check(torch.equal(got, full[k]),
                  f"(j.1) D={D}: the slices' {k} differs from the full "
                  f"render's (max |diff| {float((got - full[k]).abs().max())})")
        radii = torch.stack([o["radii"] for o in outs]).max(dim=0).values
        check(torch.equal(radii, full["radii"]),
              f"(j.1) D={D}: the slices' radii differ from the full render's")
        print(f"par (j.1) [{card}] D={D} at {W}x{PAR_H}: slices bit-equal to "
              f"the full render (render, depth, alpha, segment, T_final; "
              f"radii the slices' maximum); per slice K3 and K1 once "
              f"{json.dumps(launches)}, instances "
              f"{[int(o['num_rendered']) for o in outs]}, ms "
              f"{', '.join(f'{t:.4f}' for t in ms)} (full render "
              f"{full_ms:.4f} ms, {int(full['num_rendered'])} instances)")
    print(f"par (j.1): capacity {cap}; phase {time.perf_counter() - t0:.1f} s")


def phase_par_nccl(torch, np, card, cam, model, cap):
    """(j.2) ``make_parallel_train_step`` at world size 1 over NCCL, at
    1920x1080 in the TRAIN_CAPACITY model (phase 8's inputs): bit-equal to
    ``make_train_step`` from the same state (every state tensor and
    metric), K3, K1, K2, K4, K7 and K8 once per step; then the two
    alternated (plain, data-parallel, data-parallel, plain) for ms/step
    and device busy per step."""
    import torch.distributed as dist

    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.parallel import data_parallel as dp
    from gsplat_tpu_torch.parallel.multihost import free_port, init_multihost
    from gsplat_tpu_torch.train import trainer
    t0 = time.perf_counter()
    dev = model.device
    _, world = init_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                              device="cuda")
    check(dist.get_backend() == "nccl" and world == 1,
          f"(j.2) group: {dist.get_backend()}, world {world}")
    try:
        ti = train_inputs(torch, cam, model, cap)
        batch, state, opt = ti["batch"], ti["state"], ti["opt"]
        lrs = ti["lr_fn"](1)
        cfg = RasterizeConfig(width=W, height=H, sh_degree=3,
                              num_class=NUM_CLASS, max_instances=cap)
        bg = torch.zeros(3, device=dev)
        plain = trainer.make_train_step(cfg, opt, 3, "L1_loss", True, bg,
                                        device=dev)
        pstep = dp.make_parallel_train_step(dp.make_data_mesh(1, dev), cfg,
                                            opt, 3, "L1_loss", True, bg,
                                            device=dev)

        def parallel(params, opt_state, aux, b, lrs_):
            return pstep(params, opt_state, aux,
                         dp.stack_camera_batches([b]), lrs_)

        want = plain(*state, batch, lrs)
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        got = parallel(*state, batch, lrs)
        torch.cuda.synchronize()
        launches = {k: v for k, v in _kernels.launch_counts.items() if v}
        check(all(launches.get(k) == 1 for k in (
            "expand", "composite_forward", "composite_backward",
            "segment_sum", "ssim_forward", "ssim_backward")),
              f"(j.2) launches {launches}")
        diff = [k for k, a, b in zip(
            ("params", "opt", "aux"), got[:3], want[:3])
            if not all(torch.equal(x, y) for x, y in zip(
                flat_tensors(a), flat_tensors(b)))]
        diff += [k for k in want[3]
                 if not torch.equal(got[3][k].to(want[3][k].dtype),
                                    want[3][k])]
        check(not diff, f"(j.2) the data-parallel step at world size 1 "
              f"differs from make_train_step in {diff}")
        res = alternate_steps(torch, np, card,
                              {"plain": plain, "data-parallel": parallel},
                              ("plain", "data-parallel", "data-parallel",
                               "plain"), state, batch, lrs)
    finally:
        dist.destroy_process_group()
    print(f"par (j.2) [{card}]: data-parallel step at world size 1 over "
          f"NCCL bit-equal to make_train_step (state and metrics), launches "
          f"{json.dumps(launches)}; busy per step data-parallel "
          f"{res['data-parallel']['busy']} ms against plain "
          f"{res['plain']['busy']}; phase {time.perf_counter() - t0:.1f} s")


def flat_tensors(tree):
    """The tensors of nested tuples, in order."""
    if isinstance(tree, tuple):
        return [t for x in tree for t in flat_tensors(x)]
    return [tree]


def start_par_ranks(port, work):
    """PAR_RANKS copies of this script with ``--rank r PAR_RANKS port
    work``, started once the kernels are built: each reaches the card and
    waits for a line on its stdin (``phase_par_ranks``)."""
    ranks = []
    for r in range(PAR_RANKS):
        with open(os.path.join(work, f"rank{r}.log"), "w") as log:
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r),
                 str(PAR_RANKS), str(port), work],
                stdin=subprocess.PIPE, stdout=log, stderr=subprocess.STDOUT,
                text=True)
        atexit.register(lambda c=child: c.poll() is None and c.kill())
        ranks.append(child)
    return ranks


def rank_main(rank, world, port, work):
    """One rank of (j.3), a process of its own on the one card (``cuda:0``
    for every rank) in a gloo group: the data-parallel step on camera
    ``rank`` over a ``data`` mesh, then the tile-sharded step on camera 0
    over a ``tile`` mesh (row slice ``rank``), each with the launch counts
    zeroed just before; writes its states and counts to
    ``work/rank<rank>.pt``."""
    import numpy as np
    import torch
    torch.zeros(1, device="cuda")            # reach the card, then wait
    if sys.stdin.readline() != "go\n":
        return 1                              # the parent ended first
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.parallel import data_parallel as dp
    from gsplat_tpu_torch.parallel import tile_parallel as tp
    from gsplat_tpu_torch.parallel.multihost import init_multihost
    import torch.distributed as dist
    init_multihost(f"127.0.0.1:{port}", world, rank, device="cuda",
                   backend="gloo")
    dev = torch.device("cuda")
    model = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device=dev)
    model.load_npz(ASSET)
    seg = np.random.default_rng(0).standard_normal(
        (model.capacity, NUM_CLASS))
    model.params = model.params._replace(
        segment=torch.from_numpy(seg.astype(np.float32)).to(dev))
    pi = par_inputs(torch, np, model)
    bg = torch.zeros(3, device=dev)
    out = {}
    dstep = dp.make_parallel_train_step(
        dp.make_data_mesh(world, dev), pi["cfg"], pi["opt"], 3, "L1_loss",
        True, bg, device=dev)
    tstep, _ = tp.make_tile_sharded_train_step(
        tp.make_tile_mesh(world, dev), pi["cfg"], pi["opt"], 3, "L1_loss",
        True, bg, device=dev)
    for name, run in (
            ("dp", lambda: dstep(*pi["state"], dp.stack_camera_batches(
                [pi["batches"][rank]]), pi["lrs"])),
            ("tile", lambda: tstep(*pi["state"], pi["batches"][0],
                                   pi["lrs"]))):
        torch.cuda.synchronize()
        _kernels.reset_launch_counts()
        t = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        out[name] = dict(
            state=[x.cpu() for x in flat_tensors(tuple(res[:3]))],
            metrics={k: v.cpu() for k, v in res[3].items()},
            launches={k: v for k, v in _kernels.launch_counts.items() if v},
            s=time.perf_counter() - t)
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    dist.destroy_process_group()
    print(f"rank {rank}: ok")
    return 0


def par_oracles(torch, pi):
    """The single-process oracles of (j.3): the mean of the two cameras'
    gradients of ``make_loss_fn`` with their densification statistics and
    Adam (the data-parallel step's semantics), and ``make_train_step`` on
    camera 0 (the tile-sharded step's)."""
    from gsplat_tpu_torch.models import adam
    from gsplat_tpu_torch.models.densify import add_densification_stats
    from gsplat_tpu_torch.train import trainer
    params, opt_state, aux = pi["state"]
    cfg, opt, lrs = pi["cfg"], pi["opt"], pi["lrs"]
    dev = params.xyz.device
    bg = torch.zeros(3, device=dev)
    loss_fn = trainer.make_loss_fn(cfg, opt, 3, "L1_loss", True, bg,
                                   device=dev)
    scale = torch.tensor([0.5 * W, 0.5 * PAR_H], device=dev)
    gsum = None
    for b in pi["batches"]:
        leaves = type(params)(*[x.detach().requires_grad_(True)
                                for x in params])
        m2d = torch.zeros((params.xyz.shape[0], 2), device=dev,
                          requires_grad=True)
        loss, auxout = loss_fn(leaves, m2d, b)
        g = torch.autograd.grad(loss, [*leaves, m2d])
        aux = add_densification_stats(aux, g[-1] * scale, auxout["radii"])
        gsum = g[:-1] if gsum is None else [a + x for a, x in zip(gsum, g)]
    lrs_tree = type(params)(**{k: lrs[k] for k in params._fields})
    mean = (*adam.update(type(params)(*[x / len(pi["batches"])
                                        for x in gsum]),
                         opt_state, params, lrs_tree), aux)
    step = trainer.make_train_step(cfg, opt, 3, "L1_loss", True, bg,
                                   device=dev)
    single = step(*pi["state"], pi["batches"][0], lrs)[:3]
    return {"dp": flat_tensors(tuple(mean)),
            "tile": flat_tensors(tuple(single))}


def phase_par_ranks(torch, np, card, model, ranks, work):
    """(j.3) PAR_RANKS ranks sharing the card over gloo, each on
    ``cuda:0``: one data-parallel step (camera r on rank r) and one
    2-slice tile-sharded step (camera 0) at 1920x1152, K3, K1, K2 and K4 in
    every rank; the state bit-equal across the ranks and the gradients (the
    first moments of a cold Adam step, 0.1 g) and densification statistics
    within rtol 3e-3 and 1e-3 of each field's largest of the
    single-process oracles (phase (b)'s gradient tolerances, scaled to the
    field)."""
    t0 = time.perf_counter()
    for child in ranks:
        child.stdin.write("go\n")
        child.stdin.flush()
    # the oracles while the ranks run
    pi = par_inputs(torch, np, model)
    oracle = par_oracles(torch, pi)
    names = [f"params.{k}" for k in pi["state"][0]._fields] + ["opt.count"] + [
        f"opt.{m}.{k}" for m in ("mu", "nu")
        for k in pi["state"][0]._fields] + [
        f"aux.{k}" for k in pi["state"][2]._fields]
    for r, child in enumerate(ranks):
        child.stdin.close()
        child.wait(timeout=PAR_TIMEOUT)
        with open(os.path.join(work, f"rank{r}.log")) as f:
            out = f.read()
        sys.stdout.write(out[-4000:])
        check(child.returncode == 0 and f"rank {r}: ok" in out,
              f"(j.3) rank {r} failed (exit {child.returncode})")
    got = [torch.load(os.path.join(work, f"rank{r}.pt"))
           for r in range(PAR_RANKS)]
    for step in ("dp", "tile"):
        for r in range(1, PAR_RANKS):
            same = [n for n, a, b in zip(names, got[r][step]["state"],
                                         got[0][step]["state"])
                    if not torch.equal(a, b)]
            check(not same, f"(j.3) {step}: rank {r}'s state differs from "
                  f"rank 0's in {same}")
        for r in range(PAR_RANKS):
            n = got[r][step]["launches"]
            check(all(n.get(k, 0) >= 1 for k in (
                "expand", "composite_forward", "composite_backward",
                "segment_sum"))
                  and n.get("ssim_forward") == 1
                  and n.get("ssim_backward") == 1,
                  f"(j.3) {step} rank {r}: launches {n}")
        errs = {}
        for n, a, b in zip(names, got[0][step]["state"], oracle[step]):
            if not (n.startswith("opt.mu.") or n in (
                    "aux.xyz_gradient_accum", "aux.denom",
                    "aux.max_radii2d")):
                continue
            b = b.cpu()
            d = (a - b).abs()
            big = float(b.abs().max())
            errs[n] = float(d.max()) / max(big, 1e-30)
            check(bool((d <= 3e-3 * b.abs() + 1e-3 * big).all()),
                  f"(j.3) {step}: {n} beyond rtol 3e-3, 1e-3 of its largest "
                  f"({errs[n]:.3g} of {big:.3g})")
        m = got[0][step]["metrics"]
        check(not bool(m["overflow"]) and math.isfinite(float(m["loss"])),
              f"(j.3) {step}: overflow or non-finite loss")
        print(f"par (j.3) [{card}] {step} over {PAR_RANKS} gloo ranks on "
              f"cuda:0 at {W}x{PAR_H}: state bit-equal across the ranks, "
              f"loss {float(m['loss']):.6f}; against the oracle, largest "
              f"|diff| over each field's largest "
              f"{json.dumps({k: float(f'{v:.3g}') for k, v in errs.items()})};"
              f" launches per rank "
              f"{json.dumps([g[step]['launches'] for g in got])}, step s per "
              f"rank {[round(g[step]['s'], 3) for g in got]}")
    print(f"par (j.3): phase {time.perf_counter() - t0:.1f} s")


def phase_par_cli(torch, np, card, work, cli_files):
    """(j.4) ``scripts.train.main`` with ``--multihost`` at world size 1
    (NCCL over ``tcp://127.0.0.1``) on phase (d)'s scene and arguments: the
    files phase (d) wrote, K3x launched every iteration, the group ended."""
    import torch.distributed as dist

    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.parallel.multihost import free_port
    from gsplat_tpu_torch.scripts import train as train_cli
    t0 = time.perf_counter()
    iters = 30
    out = os.path.join(work, "cli_multihost")
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    train_cli.main([
        "-s", os.path.join(work, "cli_scene"), "-m", out, "--cull", "exact",
        "--disable_gui_server", "--iterations_override", str(iters),
        "--test_iterations", str(iters), "--densify_from_iter", "10",
        "--densification_interval", "10",
        "--densify_grad_threshold", "2e-5", "--eval", "--multihost",
        "--coordinator_address", f"127.0.0.1:{free_port()}",
        "--num_processes", "1", "--process_id", "0"])
    torch.cuda.synchronize()
    launches = {k: v for k, v in _kernels.launch_counts.items() if v}
    check(not dist.is_initialized(), "(j.4) the CLI left its group up")
    files = tree_files(out)
    check(files == cli_files, f"(j.4) files {files} differ from phase (d)'s "
          f"{cli_files}")
    check(launches.get("expand_extras", 0) >= iters,
          f"(j.4) launches {launches}")
    print(f"par (j.4) [{card}]: scripts.train --multihost at world size 1, "
          f"{iters} iterations: phase (d)'s {len(files)} files, launches "
          f"{json.dumps(launches)}; phase {time.perf_counter() - t0:.1f} s")


def tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


# (k) the viewing half on the card: the scene editor, the visualize CLI, the
# HTTP viewer, the bare-asset viewer and the render backends, on phase (h)'s
# PLY of the asset at bench.py's 1920x1080 camera
EDIT_SLOTS = 262144          # the asset's 262,046 gaussians, a power of two
VIZ_FRAMES = 6               # orbit frames a visualize run
VIEWER_PATH_FRAMES = 8       # the viewer's keyframe path (preview, export)
VIEWER_TIMED = 20            # warmed /api/generate-image round trips timed
HTTP_TIMEOUT = 120.0         # every client socket's, and the server start
ASSET_PLY = os.path.join("assets", "trained_scene.ply")
# the JAX tests' gradient tolerance between the tiled and Pallas paths
# (tests/test_pallas_composite.py:99): of each field's largest
TILED_GRAD_ATOL = 1e-3


def run_counted(torch, fn, *args, **kw):
    """``fn(*args, **kw)`` with the launch counts zeroed just before;
    returns its result and the counts just after."""
    from gsplat_tpu_torch import _kernels
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, dict(_kernels.launch_counts)


def k3_k1_once(counts, what, n=1):
    check(counts["expand"] == n and counts["composite_forward"] == n,
          f"{what}: K3 and K1 did not launch {n} time(s) each: "
          f"{json.dumps(counts)}")


@contextlib.contextmanager
def tiled_calls():
    """Records the device type of every ``composite_tiled`` call made
    through ``ops/rasterize.py`` while the block runs."""
    from gsplat_tpu_torch.ops import composite_tiled as tiled_lib
    calls = []
    orig = tiled_lib.composite_tiled

    def recorded(means2d, *args, **kw):
        calls.append(means2d.device.type)
        return orig(means2d, *args, **kw)

    tiled_lib.composite_tiled = recorded
    try:
        yield calls
    finally:
        tiled_lib.composite_tiled = orig


def stats_ms(seconds):
    import numpy as np
    ms = np.asarray(seconds) * 1e3
    return float(np.median(ms)), float(np.percentile(ms, 90))


def phase_editor(torch, np, card, ply, cam, work):
    """(k.1) ``viz/editor.py`` at the asset: its PLY in 262,144 slots with
    seeded Adam moments; the same PLY merged translated (the model grows to
    524,288 slots, the moments kept); a rotated box and class 1 selected;
    the merged scene and the box rendered, K3 and K1 once each; the box's
    class-1 gaussians copied, the copy moved and scaled, the box removed,
    the copy saved as a clip that reloads to the same rows; the alive
    counts what the masks say.  Returns the box's arguments."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.models import adam
    from gsplat_tpu_torch.models.gaussians import GaussianModel, GaussianParams
    from gsplat_tpu_torch.viz.editor import SceneEditor
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gm = GaussianModel(3, num_class=NUM_CLASS, capacity=EDIT_SLOTS, device=dev)
    gm.load_ply(ply)
    n = gm.num_alive
    check(gm.capacity == EDIT_SLOTS and n <= EDIT_SLOTS,
          f"(k.1) the PLY's {n} gaussians in {gm.capacity} slots")
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    mu = GaussianParams(*[torch.randn(t.shape, generator=gen, device=dev)
                          for t in gm.params])
    nu = GaussianParams(*[x.abs() for x in mu])
    gm.opt_state = adam.AdamState(
        count=torch.tensor(5, dtype=torch.int32, device=dev), mu=mu, nu=nu)
    ed = SceneEditor(gm)
    t1 = time.perf_counter()
    iid = ed.merge_ply(ply, translate=(3.0, 0.0, 0.0))
    torch.cuda.synchronize()
    t_merge = time.perf_counter() - t1
    merged_slots = gm.capacity
    check(iid == 1 and gm.capacity == 2 * EDIT_SLOTS
          and gm.num_alive == 2 * n and int((ed.instance == 1).sum()) == n,
          f"(k.1) merge: instance {iid}, {gm.capacity} slots, "
          f"{gm.num_alive} alive")
    for part, old in (("mu", mu), ("nu", nu)):
        new = getattr(gm.opt_state, part)
        for k, a, b in zip(GaussianParams._fields, old, new):
            check(torch.equal(b[:EDIT_SLOTS], a)
                  and not bool(b[EDIT_SLOTS:].any()),
                  f"(k.1) the growth did not keep the moment {part}.{k}")
    dst = torch.as_tensor(np.nonzero(ed.instance == 1)[0], device=dev)
    for k in ("features_dc", "features_rest", "rotation", "opacity",
              "segment", "scaling"):
        check(torch.equal(getattr(gm.params, k)[dst],
                          getattr(gm.params, k)[:n]),
              f"(k.1) merged rows' {k} differ from the PLY's")
    xyz = gm.params.xyz[:n]
    center = [float(v) for v in xyz.median(dim=0).values]
    q = torch.quantile(xyz[::16], torch.tensor([0.25, 0.75], device=dev),
                       dim=0)
    extents = [float(v) for v in (q[1] - q[0]) * 0.5]
    box_args = (center, (0.0, 30.0, 0.0), extents)
    box = ed.bbox_select(*box_args)
    cls = ed.segment_select(1)
    sel = box & cls
    check(0 < sel.sum() < box.sum() < n,
          f"(k.1) selections: box {int(box.sum())}, class 1 "
          f"{int(cls.sum())}, both {int(sel.sum())}")
    out, c_all = run_counted(torch, renderer.render, cam, gm, device=dev)
    outb, c_box = run_counted(torch, renderer.render, cam, gm,
                              bbox_mask=box, device=dev)
    k3_k1_once(c_all, "(k.1) the merged scene's render")
    k3_k1_once(c_box, "(k.1) the box's render")
    for o, what in ((out, "merged"), (outb, "box")):
        check(not bool(o["overflow"])
              and all(bool(torch.isfinite(o[k]).all())
                      for k in ("render", "depth", "alpha", "segment")),
              f"(k.1) the {what} render: overflow or non-finite output")
    check(float(outb["alpha"].sum()) < float(out["alpha"].sum()),
          "(k.1) the box's render covers no less than the scene's")
    iid2 = ed.copy(sel, translate=(0.0, 0.5, 0.0))
    ed.transform_instance(iid2, translate=(0.1, 0.0, 0.0), scale=1.2)
    check(iid2 == 2 and gm.num_alive == 2 * n + int(sel.sum()),
          f"(k.1) copy: {gm.num_alive} alive")
    removed = ed.remove(box)
    check(removed == int(box.sum())
          and gm.num_alive == 2 * n + int(sel.sum()) - removed,
          f"(k.1) remove: {removed} removed, {gm.num_alive} alive")
    clip_mask = ed.instance == iid2
    clip = os.path.join(work, "k_clip.ply")
    ed.save_clip(clip, clip_mask)
    torch.cuda.synchronize()
    t_edit = time.perf_counter() - t1
    back = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device=dev)
    back.load_ply(clip)
    keep = np.nonzero(clip_mask & ed.alive_mask())[0]
    check(back.num_alive == len(keep) == int(sel.sum()),
          f"(k.1) the clip holds {back.num_alive} of {len(keep)} rows")
    kt = torch.as_tensor(keep, device=dev)
    for k in GaussianParams._fields:
        check(torch.equal(getattr(back.params, k)[:len(keep)],
                          getattr(gm.params, k)[kt]),
              f"(k.1) the clip's {k} does not reload equal")
    print(f"editor (k.1) {W}x{H} [{card}]: {n} gaussians in {EDIT_SLOTS} "
          f"slots, merged to {merged_slots} ({t_merge:.2f} s with the PLY "
          f"read, moments kept); box {int(box.sum())}, class 1 "
          f"{int(cls.sum())}, copied {int(sel.sum())} (to {gm.capacity} "
          f"slots), removed {removed}, {gm.num_alive} alive; edits and clip "
          f"{t_edit:.2f} s; renders of "
          f"the merged scene and the box: launches {json.dumps(c_all)}, "
          f"{json.dumps(c_box)}; phase {time.perf_counter() - t0:.1f} s")
    return box_args


def phase_visualize(torch, np, card, model_dir, ply, box_args, work):
    """(k.2) ``scripts.visualize.main`` on phase (h)'s model directory in
    the rgb, depth and segment modes (a rotated box; a sub-scene merged;
    the class-1 filter, a clip and the video), ``VIZ_FRAMES`` orbit frames
    a run with the counters zeroed just before: K3 and K1 once a frame,
    every frame bit-equal to ``frame_for_mode`` of ``renderer.render`` on
    the same camera and model, the frame files or video written, the clip
    holding the class filter's gaussians."""
    from PIL import Image

    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.scripts import visualize as viz_cli
    from gsplat_tpu_torch.viz.editor import SceneEditor
    t0 = time.perf_counter()
    center, rot, ext = box_args
    clip = os.path.join(work, "k_viz_clip.ply")
    runs = (("rgb", ["--bbox", *map(str, center + ext),
                     "--bbox_rot", *map(str, rot)]),
            ("depth", ["--sub_scene", ply]),
            ("segment", ["--segment_class", "1", "--save_clip", clip,
                         "--video"]))
    lines = []
    for mode, extra in runs:
        calls = []
        orig = renderer.render

        def recording(cam, gaussians, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig(cam, gaussians, **kw)
            torch.cuda.synchronize()
            calls.append((cam, gaussians, kw, time.perf_counter() - t))
            return out

        renderer.render = recording
        try:
            with clocked_calls(torch, viz_cli, ("frame_for_mode",)) as sec:
                frames, counts = run_counted(torch, viz_cli.main, [
                    "-m", model_dir, "--mode", mode, "--orbit_frames",
                    str(VIZ_FRAMES), *extra])
        finally:
            renderer.render = orig
        k3_k1_once(counts, f"(k.2) visualize --mode {mode}", VIZ_FRAMES)
        check(len(frames) == len(calls) == VIZ_FRAMES
              and all(f.shape == (H, W, 3) for f in frames),
              f"(k.2) --mode {mode}: {len(frames)} frames")
        for (cam, g, kw, _), frame in zip(calls, frames):
            again = viz_cli.frame_for_mode(orig(cam, g, **kw), mode,
                                           g.num_class)
            check(np.array_equal(again, frame),
                  f"(k.2) --mode {mode}: a frame differs from frame_for_mode"
                  "(renderer.render) on its camera")
        base = os.path.join(model_dir, f"viz_{mode}")
        if mode == "segment":
            fdir = base + "_frames"
            check(os.path.exists(base + ".mp4")
                  or len(os.listdir(fdir)) == VIZ_FRAMES,
                  "(k.2) --video wrote neither the mp4 nor the frames")
        else:
            fdir = base
            check(len(os.listdir(fdir)) == VIZ_FRAMES,
                  f"(k.2) --mode {mode}: {os.listdir(fdir)}")
        first = np.asarray(Image.open(os.path.join(fdir, "00000.png")))
        check(np.array_equal(first, (np.clip(frames[0], 0, 1) * 255).astype(
            np.uint8)), f"(k.2) --mode {mode}: the PNG is not the frame")
        r_med, _ = stats_ms([c[3] for c in calls])
        f_med, _ = stats_ms(sec["frame_for_mode"])
        lines.append(f"{mode}: render {r_med:.3f} + frame_for_mode "
                     f"{f_med:.3f} ms a frame (medians)")
    gm = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device="cuda")
    gm.load_ply(ply)
    want = int(SceneEditor(gm).segment_select(1).sum())
    back = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device="cuda")
    back.load_ply(clip)
    check(back.num_alive == want, f"(k.2) the clip holds {back.num_alive} "
          f"gaussians, the class filter {want}")
    print(f"visualize CLI (k.2) {W}x{H} [{card}]: {VIZ_FRAMES} frames a "
          f"mode, K3 and K1 once a frame, every frame bit-equal to "
          f"frame_for_mode(renderer.render); {'; '.join(lines)}; clip of "
          f"{want}; phase {time.perf_counter() - t0:.1f} s")


def http_get(port, path):
    """(body, content type, seconds) of one loopback GET."""
    import urllib.request
    t = time.perf_counter()
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=HTTP_TIMEOUT) as r:
        body = r.read()
        kind = r.headers.get("Content-Type")
    return body, kind, time.perf_counter() - t


@contextlib.contextmanager
def serving(srv):
    """``srv.serve(port=0)`` on a thread; yields the port; shuts it down."""
    import threading
    t = threading.Thread(target=srv.serve, kwargs=dict(port=0), daemon=True)
    t.start()
    check(srv.serving.wait(HTTP_TIMEOUT), "the render server did not start")
    try:
        yield srv.httpd.server_address[1]
    finally:
        srv.httpd.shutdown()
        t.join(HTTP_TIMEOUT)
        check(not t.is_alive(), "the render server did not stop")


def phase_viewer(torch, np, card, ply, cam, work):
    """(k.3) ``viz/render_app.RenderServer`` on the asset's PLY over
    loopback HTTP: the pages byte for byte, ``/api/splats`` as
    ``pack_splats`` (read back to the alive rows), ``/api/viewer-info`` as
    ``scene_info``, ``/api/generate-image`` for every motion key and ``m``,
    ``,``, ``.``, ``space``, ``p``, ``b`` and ``y``, each PNG the one
    ``render_png`` makes on a twin server after the same key, K3 and K1
    once a frame (and once an exported frame); then 20 warmed frames
    timed, the render, ``frame_for_mode``, the overlay and the PNG encode
    clocked apart inside the handler."""
    import io

    from PIL import Image

    from gsplat_tpu_torch.core.cameras import Camera
    from gsplat_tpu_torch.models.gaussians import GaussianModel
    from gsplat_tpu_torch.viz import render_app, webgl_viewer
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    gm = GaussianModel(3, num_class=NUM_CLASS, capacity=1, device=dev)
    gm.load_ply(ply)
    scene_cams = [Camera(colmap_id=i, R=np.eye(3), T=np.array(T),
                         FoVx=cam.FoVx, FoVy=cam.FoVy,
                         image=np.zeros((3, 8, 8), np.float32),
                         image_name=f"v{i}", uid=i)
                  for i, T in enumerate(TRAINER_POSES)]
    srv, twin = (render_app.RenderServer(
        gm, cam, scene_cams=scene_cams, n_path_frames=VIEWER_PATH_FRAMES,
        out_dir=os.path.join(work, f"k_viewer_{name}"))
        for name in ("served", "twin"))
    keys = (list(render_app.RenderServer.KEY_ACTIONS)
            + ["m", "m", "m", ",", "d", "l", ",", ".", ",", "space", "none",
               "p", "b", "w", "y"])
    per_frame = {}
    with serving(srv) as port:
        check(http_get(port, "/")[0] == render_app._CLIENT_HTML.encode(),
              "(k.3) / is not the client page")
        check(http_get(port, "/viewer")[0]
              == webgl_viewer.VIEWER_HTML.encode(),
              "(k.3) /viewer is not the WebGL page")
        splats, kind, s_splats = http_get(port, "/api/splats")
        check(kind == "application/octet-stream"
              and splats == webgl_viewer.pack_splats(gm),
              "(k.3) /api/splats is not pack_splats' buffer")
        pos = webgl_viewer.unpack_splats(splats)[0]
        check(np.array_equal(pos, gm.params.xyz[gm.aux.alive].cpu().numpy()),
              "(k.3) /api/splats does not read back to the alive rows")
        info = json.loads(http_get(port, "/api/viewer-info")[0])
        check(info == json.loads(json.dumps(webgl_viewer.scene_info(gm,
                                                                    cam))),
              f"(k.3) /api/viewer-info {info}")
        for key in keys:
            (png, kind, _), counts = run_counted(
                torch, http_get, port, f"/api/generate-image?type={key}")
            exported = key == "y"
            k3_k1_once(counts, f"(k.3) /api/generate-image?type={key}",
                       1 + (VIEWER_PATH_FRAMES if exported else 0))
            per_frame[key] = counts["composite_forward"]
            twin.handle_key(key)
            check(kind == "image/png" and png == twin.render_png(),
                  f"(k.3) key {key!r}: the PNG differs from render_png's")
        check(srv.mode == "rgb" and srv.overlay and srv.limit
              and len(srv.keyframes) == 2, "(k.3) the server's state")
        poses = np.load(os.path.join(srv.out_dir, "poses_render.npy"))
        check(poses.shape == (VIEWER_PATH_FRAMES, 4, 4)
              and srv.last_export is not None
              and os.path.exists(srv.last_export[1]),
              f"(k.3) the export: {srv.last_export}")
        frame = np.asarray(Image.open(io.BytesIO(png)))
        check(frame.shape == (H, W, 3), f"(k.3) a PNG of {frame.shape}")

        names = ("render", "frame_for_mode", "encode_png")
        for _ in range(2):
            http_get(port, "/api/generate-image?type=l")
        with clocked_calls(torch, render_app, names) as parts, \
                clocked_calls(torch, render_app.RenderServer,
                              ("_draw_overlay",)) as over:
            trips = [http_get(port, "/api/generate-image?type=l")[2]
                     for _ in range(VIEWER_TIMED)]
        parts.update(over)
        check(all(len(v) == VIEWER_TIMED for v in parts.values()),
              "(k.3) clocked parts: "
              + json.dumps({k: len(v) for k, v in parts.items()}))
        rest = [t - sum(parts[k][i] for k in parts)
                for i, t in enumerate(trips)]
        timed = {"round trip": stats_ms(trips), "remainder": stats_ms(rest),
                 **{k: stats_ms(v) for k, v in parts.items()}}
    print(f"viewer (k.3) {W}x{H} [{card}]: pages and APIs equal; "
          f"/api/splats {len(splats)} bytes in {s_splats * 1e3:.1f} ms; "
          f"K1 launches per /api/generate-image {json.dumps(per_frame)}; "
          f"{VIEWER_TIMED} warmed frames (overlay on), median and p90 ms: "
          + "; ".join(f"{k} {m:.3f}, {p:.3f}" for k, (m, p) in timed.items())
          + f"; phase {time.perf_counter() - t0:.1f} s")


def phase_asset_viewer(torch, np, card):
    """(k.4) ``tools/serve_asset_viewer`` on ``assets/trained_scene.ply``
    at its 960x540 default: one ``/api/generate-image`` (K3 and K1 once)
    and one ``/api/splats`` round trip."""
    import io

    from PIL import Image

    from gsplat_tpu_torch.tools import serve_asset_viewer
    from gsplat_tpu_torch.viz import webgl_viewer
    t0 = time.perf_counter()
    srv, _ = serve_asset_viewer.build_server([ASSET_PLY, "--port", "0"])
    with serving(srv) as port:
        (png, _, s_png), counts = run_counted(
            torch, http_get, port, "/api/generate-image?type=none")
        k3_k1_once(counts, "(k.4) the asset viewer's frame")
        frame = np.asarray(Image.open(io.BytesIO(png)))
        check(frame.shape == (540, 960, 3) and frame.max() > 0,
              f"(k.4) the frame: {frame.shape}")
        splats, _, s_splats = http_get(port, "/api/splats")
        check(splats == webgl_viewer.pack_splats(srv.gaussians),
              "(k.4) /api/splats is not pack_splats' buffer")
    print(f"asset viewer (k.4) [{card}]: {ASSET_PLY}, "
          f"{srv.gaussians.num_alive} gaussians, 960x540 frame in "
          f"{s_png * 1e3:.1f} ms (first, launches {json.dumps(counts)}), "
          f"/api/splats {len(splats)} bytes in {s_splats * 1e3:.1f} ms; "
          f"phase {time.perf_counter() - t0:.1f} s")


def phase_backends(torch, np, card, model, cam, bins, calls):
    """(k.5) The render backends on the card.  Phase (g)'s seeded scene of
    4,000 gaussians at 256x256 (no tile over ``k_max``): ``"jnp"`` and
    ``"reference"`` renders bit-equal to each other, K3 and no K1; within
    the JAX tests' tiled-against-Pallas tolerances of ``"auto"`` (K1), the
    images and the gradients (a cold Adam step's first moments) of one
    ``make_train_step`` step alike; ``"pallas"`` bit-equal to ``"auto"``.
    Then one ``"jnp"`` render at the asset: its time, its peak memory, and
    the tiles over ``k_max`` where it departs from ``"auto"``."""
    from gsplat_tpu_torch import renderer
    from gsplat_tpu_torch.config import OptimizationParams
    from gsplat_tpu_torch.core.cameras import Camera
    from gsplat_tpu_torch.models import adam
    from gsplat_tpu_torch.models.gaussians import (GaussianParams,
                                                   params_from_numpy)
    from gsplat_tpu_torch.ops.preprocess import TILE_X, TILE_Y
    from gsplat_tpu_torch.ops.rasterize import RasterizeConfig
    from gsplat_tpu_torch.train import trainer as trainer_lib
    from gsplat_tpu_torch.train.schedules import make_lr_fn
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    n, S = TILE_GAUSSIANS, TILE_SIZE
    rng = np.random.default_rng(16)
    fields = dict(
        xyz=rng.standard_normal((n, 3)) * 1.2,
        features_dc=rng.standard_normal((n, 1, 3)) * 0.8,
        features_rest=rng.standard_normal((n, 15, 3)) * 0.2,
        scaling=rng.standard_normal((n, 3)) * 0.5 - 2.5,
        rotation=rng.standard_normal((n, 4)),
        opacity=rng.standard_normal((n, 1)) * 1.5,
        segment=rng.standard_normal((n, NUM_CLASS)))
    small = params_from_numpy(fields, device=dev)
    scam = Camera(colmap_id=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]),
                  FoVx=math.radians(60.0), FoVy=math.radians(60.0),
                  image=rng.uniform(size=(3, S, S)).astype(np.float32),
                  image_name="backends", uid=0)
    backends = ("auto", "pallas", "jnp", "reference")
    outs, counts = {}, {}
    for b in backends:
        before = len(calls)
        outs[b], counts[b] = run_counted(
            torch, renderer.render, scam, small, backend=b,
            max_instances=1 << 19, device=dev)
        tiled = b in ("jnp", "reference")
        check(len(calls) - before == (1 if tiled else 0),
              f"(k.5) backend {b!r}: composite_tiled ran "
              f"{len(calls) - before} times")
        check(counts[b]["expand"] == 1
              and counts[b]["composite_forward"] == (0 if tiled else 1),
              f"(k.5) backend {b!r}: launches {json.dumps(counts[b])}")
    keys = ("render", "depth_raw", "alpha", "segment")
    for a, b in (("pallas", "auto"), ("reference", "jnp")):
        for k in keys:
            check(torch.equal(outs[a][k], outs[b][k]),
                  f"(k.5) {a!r} and {b!r} differ in {k}")
    img_err = {}
    for k in keys:
        tol = ATOL["depth"] if k == "depth_raw" else ATOL[
            "rgb" if k == "render" else k]
        img_err[k] = float((outs["jnp"][k] - outs["auto"][k]).abs().max())
        check(img_err[k] <= tol, f"(k.5) 'jnp' {k} is {img_err[k]} from "
              f"'auto' (tolerance {tol})")

    opt = OptimizationParams()
    lrs = make_lr_fn(opt, 1.0)(100)
    batch = trainer_lib.camera_batch(scam, device=dev)
    mus, step_counts = {}, {}
    for b in ("auto", "jnp", "reference"):
        cfg = RasterizeConfig(width=S, height=S, num_class=NUM_CLASS,
                              max_instances=1 << 19, backend=b)
        step = trainer_lib.make_train_step(cfg, opt, 3, None, True,
                                           np.zeros(3, np.float32),
                                           device=dev)
        m = params_from_numpy(fields, device=dev)
        (p1, st, _, met), step_counts[b] = run_counted(
            torch, step, m.params, adam.init(m.params), m.aux, batch, lrs)
        check(all(bool(torch.isfinite(x).all()) for x in p1)
              and math.isfinite(float(met["loss"])),
              f"(k.5) the {b!r} step: non-finite state or loss")
        mus[b] = st.mu
    check(step_counts["auto"]["composite_backward"] == 1
          and step_counts["jnp"]["composite_forward"] == 0
          and step_counts["jnp"]["composite_backward"] == 0
          and step_counts["jnp"]["expand"] == 1,
          f"(k.5) step launches {json.dumps(step_counts)}")
    grad_err = {}
    for b in ("jnp", "reference"):
        for k, x, y in zip(GaussianParams._fields, mus[b], mus["auto"]):
            scale = float(y.abs().max()) + 1e-12
            e = float((x - y).abs().max()) / scale
            grad_err[k] = max(grad_err.get(k, 0.0), e)
            check(e <= TILED_GRAD_ATOL, f"(k.5) the {b!r} step's gradient "
                  f"of {k} is {e:.3g} of its largest from 'auto''s")
    grads_equal = all(torch.equal(x, y) for x, y in zip(
        mus["jnp"], mus["reference"]))

    # the asset at 1080p through the tiled path
    gx = (W + TILE_X - 1) // TILE_X
    over = (bins.tile_count > 1024).nonzero()[:, 0]
    auto, _ = run_counted(torch, renderer.render, cam, model, device=dev)
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    jnp_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        big, c_big = run_counted(torch, renderer.render, cam, model,
                                 backend="jnp", device=dev)
        jnp_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated() - base_mem
    check(c_big["expand"] == 1 and c_big["composite_forward"] == 0
          and not bool(big["overflow"]),
          f"(k.5) the 1080p 'jnp' render: {json.dumps(c_big)}")
    cut = torch.zeros(H, W, dtype=torch.bool, device=dev)
    for t in over.tolist():
        ty, tx = divmod(t, gx)
        cut[ty * TILE_Y:(ty + 1) * TILE_Y,
            tx * TILE_X:(tx + 1) * TILE_X] = True
    diff = (big["render"] - auto["render"]).abs().amax(0)
    out_err = float(diff[~cut].max())
    in_err = float(diff[cut].max()) if len(over) else 0.0
    check(out_err <= ATOL["rgb"], f"(k.5) the 1080p 'jnp' render is "
          f"{out_err} from 'auto' outside the cut tiles")
    print(f"backends (k.5) [{card}]: {S}x{S}, {n} gaussians: 'pallas' = "
          f"'auto' and 'reference' = 'jnp' bit for bit; 'jnp' against "
          f"'auto' max |diff| {json.dumps(img_err)}; step gradients "
          f"(first moments) within {json.dumps(grad_err)} of each field's "
          f"largest, 'jnp' and 'reference' bit-equal: {grads_equal}; "
          f"launches {json.dumps(counts['jnp'])} a tiled render, "
          f"{json.dumps(step_counts['jnp'])} a tiled step; {W}x{H} asset "
          f"'jnp': {min(jnp_ms):.2f} to {max(jnp_ms):.2f} ms a render, peak "
          f"{peak / 2**20:.1f} MiB over the resident {base_mem / 2**20:.1f}, "
          f"{len(over)} tiles over k_max = 1024 (largest "
          f"{int(bins.tile_count.max())} instances): max |rgb diff| from "
          f"'auto' {in_err:.4g} inside them, {out_err:.3g} outside; "
          f"composite_tiled ran on {sorted(set(calls))}; phase "
          f"{time.perf_counter() - t0:.1f} s")


def phase_viewing(torch, np, card, model, cam, bins, work):
    """(k) the viewing paths on the card, in order (k.1) to (k.5), with
    every ``composite_tiled`` call recorded: the ``"auto"`` paths make
    none."""
    t0 = time.perf_counter()
    model_dir = os.path.join(work, "render_model")
    ply = os.path.join(model_dir, "point_cloud", "iteration_1",
                       "point_cloud.ply")
    with tiled_calls() as calls:
        box_args = phase_editor(torch, np, card, ply, cam, work)
        phase_visualize(torch, np, card, model_dir, ply, box_args, work)
        phase_viewer(torch, np, card, ply, cam, work)
        phase_asset_viewer(torch, np, card)
        check(not calls, f"(k) 'auto' ran composite_tiled {len(calls)} "
              "times")
        phase_backends(torch, np, card, model, cam, bins, calls)
        check(set(calls) == {"cuda"}, f"(k) composite_tiled on {calls}")
    print(f"viewing (k): phase {time.perf_counter() - t0:.1f} s")


# (l) the data-prep half on the host, the native I/O, DPT at full width on
# the card, and the DPT command lines feeding a training run: phase (h)'s
# scene (five 1920x1080 views of the asset) and PLY
DPT_MODELS = ("dpt_hybrid", "dpt_large")
DPT_SEGMENT_CLASSES = 150    # ADE20k, the published segmentation head
DPT_WARM, DPT_TIMED = 2, 5
# the card's output against the CPU's, of the CPU output's largest magnitude
DPT_REL_TOL = 1e-4
PREP_TRAIN_ITERS = 10
SEG150_VIEWS = 1
PREP_KERNELS = ("expand", "composite_forward_packed_quad",
                "composite_backward_packed_quad", "segment_sum")
# a stand-in for colmap (the card's machine has none): logs its arguments
# and writes what the converter reads next
COLMAP_STUB = r'''import os, shutil, sys
args = sys.argv[1:]
with open(os.environ["COLMAP_STUB_LOG"], "a") as f:
    f.write(" ".join(args) + "\n")
opt = dict(zip(args[1::2], args[2::2]))
if args[0] == "mapper":
    os.makedirs(os.path.join(opt["--output_path"], "0"), exist_ok=True)
if args[0] == "image_undistorter":
    out = opt["--output_path"]
    os.makedirs(os.path.join(out, "sparse"), exist_ok=True)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(os.path.join(out, "sparse", name), "wb") as f:
            f.write(name.encode())
    shutil.copytree(opt["--image_path"], os.path.join(out, "images"),
                    dirs_exist_ok=True)
'''


def phase_prep_host(torch, np, card, scene_dir, work):
    """(l.1) The data-prep half on the host: (h)'s five camera poses as SLAM
    poses through ``slam_to_nerf`` (its transforms.json holds (h)'s poses
    after the axis flip and back, float32-rounded as the converter reads
    them), ``compute_block_seq``, ``split_blocks`` and
    ``nerf_to_poses_bounds``; ``scripts.convert.main`` with a stub colmap
    (the four command lines received) and the ``--resize`` pyramid of the
    five 1080p images, timed."""
    from gsplat_tpu_torch.data import converters
    from gsplat_tpu_torch.scripts import convert as convert_cli
    t0 = time.perf_counter()
    with open(os.path.join(scene_dir, "transforms.json")) as f:
        frames = json.load(f)["frames"]
    root = os.path.join(work, "slam")
    os.makedirs(os.path.join(root, "images"))
    lines = []
    for i, fr in enumerate(frames):
        c2w = np.array(fr["transform_matrix"])
        c2w[:3, 1:3] *= -1         # back to the SLAM (COLMAP) axes
        lines.append(f"{i} " + " ".join(repr(float(v))
                                        for v in c2w[:3].ravel()))
        shutil.copy(os.path.join(scene_dir, fr["file_path"]),
                    os.path.join(root, "images", f"{i}.png"))
    for name in ("KeyFramePose.txt", "Pose.txt"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    intr = dict(fl_x=1000.0, fl_y=1000.0, cx=W / 2, cy=H / 2, w=W, h=H)
    tf = converters.slam_to_nerf(root, intr, image_ext="png")
    with open(tf) as f:
        got = json.load(f)["frames"]
    check(len(got) == len(frames) and all(
        np.array_equal(np.array(g["transform_matrix"]),
                       np.array(fr["transform_matrix"], np.float32))
        for g, fr in zip(got, frames)),
        "(l.1) slam_to_nerf's poses differ from (h)'s")
    blocks = converters.compute_block_seq(root, K=0.1)
    outs = converters.split_blocks(root, intr, blocks, image_ext="png")
    n_block_frames = 0
    for out in outs:
        with open(out) as f:
            n_block_frames += len(json.load(f)["frames"])
    pb = np.load(converters.nerf_to_poses_bounds(tf))
    check(pb.shape == (len(frames), 17) and bool(np.all(
        pb[:, [4, 9, 14]] == [H, W, 1000.0])), f"(l.1) poses_bounds {pb.shape}")

    src = os.path.join(work, "convert_scene")
    os.makedirs(os.path.join(src, "input"))
    for fr in frames:
        shutil.copy(os.path.join(scene_dir, fr["file_path"]),
                    os.path.join(src, "input"))
    stub = os.path.join(work, "colmap_stub")
    with open(stub, "w") as f:
        f.write(f"#!{sys.executable}\n" + COLMAP_STUB)
    os.chmod(stub, 0o755)
    log = os.path.join(work, "colmap_stub.log")
    os.environ["COLMAP_STUB_LOG"] = log
    try:
        t1 = time.perf_counter()
        with clocked_calls(torch, convert_cli, ("run",)) as seconds:
            convert_cli.main(["-s", src, "--colmap_executable", stub,
                              "--resize"])
        t_convert = time.perf_counter() - t1
    finally:
        del os.environ["COLMAP_STUB_LOG"]
    with open(log) as f:
        said = [ln.split()[0] for ln in f]
    check(said == ["feature_extractor", "exhaustive_matcher", "mapper",
                   "image_undistorter"], f"(l.1) colmap received {said}")
    for scale in (2, 4, 8):
        d = os.path.join(src, f"images_{scale}")
        check(len(os.listdir(d)) == len(frames), f"(l.1) {d}")
    from PIL import Image
    with Image.open(os.path.join(src, "images_8",
                                 os.path.basename(frames[0]["file_path"]))) \
            as im:
        check(im.size == (W // 8, H // 8), f"(l.1) images_8 {im.size}")
    t_cmds = sum(seconds["run"])
    print(f"prep host (l.1) [{card}]: slam_to_nerf of {len(frames)} poses "
          f"equal to (h)'s, {len(blocks)} blocks ({n_block_frames} frames "
          f"in split_blocks), poses_bounds {pb.shape}; convert CLI "
          f"{t_convert:.3f} s, of it the four stub commands "
          f"{t_cmds:.3f} s and the --resize pyramid of {len(frames)} "
          f"{W}x{H} images (and the moves) {t_convert - t_cmds:.3f} s; "
          f"phase {time.perf_counter() - t0:.1f} s")


def write_points3d_bin(np, path, xyz, rgb, err):
    """COLMAP's binary points3D layout (tests/test_colmap_native.py's
    fixture, written in bulk): id, xyz, rgb, error, a track of one
    (image, point2D) pair."""
    rec = np.zeros(len(xyz), np.dtype([
        ("id", "<i8"), ("xyz", "<f8", 3), ("rgb", "u1", 3), ("err", "<f8"),
        ("tlen", "<u8"), ("track", "<i4", 2)]))
    rec["id"] = np.arange(len(xyz))
    rec["xyz"], rec["rgb"], rec["err"] = xyz, rgb, err
    rec["tlen"] = 1
    rec["track"][:, 1] = np.arange(len(xyz))
    with open(path, "wb") as f:
        f.write(np.uint64(len(xyz)).tobytes())
        f.write(rec.tobytes())


def median_s(fn, n=3):
    out, times = None, []
    for _ in range(n):
        t = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t)
    return out, float(sorted(times)[n // 2])


def phase_native_io(np, card, ply, work):
    """(l.2) The native I/O: the library loads; (h)'s PLY of the asset
    through ``read_ply`` (the native path, counted) equal in values to the
    pure-python read (float32-promoted where native); a ``points3D.bin``
    of the asset's points both ways (the native xyz and error
    float32-rounded); each path's median ms of three reads."""
    from gsplat_tpu_torch.data import colmap, native
    from gsplat_tpu_torch.data import ply as ply_io
    t0 = time.perf_counter()
    check(native.available(), "(l.2) the native library does not load")
    native.reset_call_counts()
    got, s_native = median_s(lambda: ply_io.read_ply(ply))
    check(native.call_counts["ply_read"] == 3,
          f"(l.2) read_ply took the python path: {native.call_counts}")
    want, s_python = median_s(lambda: ply_io.read_ply_python(ply))
    check(sorted(got) == sorted(want) and all(
        got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
        for k in want), "(l.2) the native PLY read differs")
    n = len(want["x"])
    xyz = np.stack([want["x"], want["y"], want["z"]], 1).astype(
        np.float64) * (1 + 1e-9)
    rng = np.random.default_rng(17)
    rgb = rng.integers(0, 256, (n, 3))
    err = rng.uniform(0, 2, n)
    pts = os.path.join(work, "points3D.bin")
    write_points3d_bin(np, pts, xyz, rgb, err)
    (pxyz, prgb, perr), s_pts_native = median_s(
        lambda: colmap.read_points3D_binary(pts))
    check(native.call_counts["points3d"] == 3,
          f"(l.2) read_points3D_binary: {native.call_counts}")
    (qxyz, qrgb, qerr), s_pts_python = median_s(
        lambda: colmap.read_points3D_binary_python(pts), n=1)
    f32 = np.float32
    check(np.array_equal(pxyz, qxyz.astype(f32)) and np.array_equal(
        prgb, qrgb) and np.array_equal(perr, qerr.astype(f32)),
        "(l.2) the native points3D read differs")
    print(f"native io (l.2) [{card}]: {native.library_path()}; read_ply of "
          f"{ply} ({n} gaussians, {len(want)} properties, "
          f"{os.path.getsize(ply)} bytes): native {s_native * 1e3:.2f} ms, "
          f"python {s_python * 1e3:.2f} ms (median of 3); points3D.bin of "
          f"{n} points: native {s_pts_native * 1e3:.2f} ms, python "
          f"{s_pts_python * 1e3:.2f} ms (one read); calls "
          f"{json.dumps(native.call_counts)}; phase "
          f"{time.perf_counter() - t0:.1f} s")


def dpt_inputs(np, scene_dir):
    """(h)'s first view prepared as the CLIs prepare it (672x384, the
    minimal resize of 1920x1080) and its centre 1080x1080 crop (384x384)."""
    from gsplat_tpu_torch.depth import transforms as DT
    img = DT.read_image(os.path.join(scene_dir, "images", "view0.png"))
    x0 = (W - H) // 2
    return {"384x384": DT.prepare(img[:, x0:x0 + H])[None],
            "672x384": DT.prepare(img)[None]}


def phase_dpt(torch, np, card, scene_dir):
    """(l.3) DPT at full width on the card: the published DPT-Hybrid and
    DPT-Large (and the hybrid's 150-class segmentation head) from a seeded
    ``torch.Generator`` through ``init_params``, at 384x384 and 672x384:
    the card's output within DPT_REL_TOL of the largest magnitude of the
    same model's output on the CPU; ms per image (median of DPT_TIMED
    warmed runs, CUDA events), device busy ms and the largest device
    operations (a profiled window of two), and peak memory."""
    import copy

    from gsplat_tpu_torch.depth import dpt
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    xs = dpt_inputs(np, scene_dir)
    rows = []
    cases = [(m, "depth", 150) for m in DPT_MODELS] + [
        ("dpt_hybrid", "segmentation", DPT_SEGMENT_CLASSES)]
    for seed, (mt, head, ncls) in enumerate(cases):
        cfg = dpt.dpt_config(mt, head=head, num_classes=ncls)
        t1 = time.perf_counter()
        cpu = dpt.init_params(cfg, torch.Generator().manual_seed(seed),
                              device="cpu")
        t_init = time.perf_counter() - t1
        n_params = sum(p.numel() for p in cpu.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        card_model = copy.deepcopy(cpu).to(dev)
        sizes = ("672x384",) if head == "segmentation" else tuple(xs)
        for size in sizes:
            x = xs[size]
            want = dpt.dpt_forward(cpu, x).numpy()
            xd = torch.from_numpy(x).to(dev)
            for _ in range(DPT_WARM):
                got = dpt.dpt_forward(card_model, xd)
            torch.cuda.synchronize()
            times = []
            for _ in range(DPT_TIMED):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                got = dpt.dpt_forward(card_model, xd)
                b.record()
                torch.cuda.synchronize()
                times.append(a.elapsed_time(b))
            profile_window(torch, lambda: dpt.dpt_forward(card_model, xd),
                           2, f"{mt} {head} image at {size}",
                           float(np.median(times)), card, top=5)
            got = got.cpu().numpy()
            scale = float(np.abs(want).max())
            gap = float(np.abs(got - want).max())
            check(got.shape == want.shape and np.isfinite(got).all()
                  and scale > 0 and gap <= DPT_REL_TOL * scale,
                  f"(l.3) {mt} {head} at {size}: card against CPU "
                  f"{gap} of {scale}")
            rows.append(dict(model=mt, head=head, size=size,
                             ms=float(np.median(times)), gap=gap,
                             scale=scale))
            print(f"dpt (l.3) [{card}]: {mt} {head} ({n_params} "
                  f"parameters, init {t_init:.1f} s) at {size}: "
                  f"{np.median(times):.3f} ms per image (median of "
                  f"{DPT_TIMED}; min {min(times):.3f}, max "
                  f"{max(times):.3f}), output {got.shape}, card against "
                  f"CPU max |diff| {gap:.3g} of largest {scale:.6g} "
                  f"({gap / scale:.3g})")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
        print(f"dpt (l.3) [{card}]: {mt} {head}: peak {peak:.1f} MiB over "
              f"the phase's start (weights "
              f"{n_params * 4 / 2**20:.1f} MiB)")
        del card_model, cpu
        torch.cuda.empty_cache()
    print(f"dpt (l.3) [{card}]: phase {time.perf_counter() - t0:.1f} s")
    return rows


def phase_dpt_clis(torch, np, card, scene_dir, work):
    """(l.4) The DPT command lines on (h)'s five 1080p views: depth PNGs
    into the scene's ``depth/`` (16-bit, 1920x1080), segmentation at 150
    classes into a scratch folder (timed; on SEG150_VIEWS of the views: the
    CLI's host work takes seconds a view) and at NUM_CLASS into
    ``segment/``; then ``scripts.train.main`` on the scene at full
    resolution with the depth and segment losses for PREP_TRAIN_ITERS
    iterations, the counters zeroed just before: K3, K1, K2 and K4 once an
    iteration, the loss finite, the files written."""
    from PIL import Image

    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.depth import dpt as dpt_mod
    from gsplat_tpu_torch.depth import transforms as DT
    from gsplat_tpu_torch.scripts import run_monodepth, run_segmentation
    from gsplat_tpu_torch.scripts import train as train_cli
    t0 = time.perf_counter()
    images = os.path.join(scene_dir, "images")
    names = sorted(os.listdir(images))
    n = len(names)
    res = {}
    seg150 = os.path.join(work, "segment150")
    few = os.path.join(work, "segment150_views")
    os.makedirs(few)
    for name in names[:SEG150_VIEWS]:
        shutil.copy(os.path.join(images, name), few)
    for tag, main, src, out, extra in (
            ("monodepth", run_monodepth.main, images,
             os.path.join(scene_dir, "depth"), []),
            ("segmentation 150", run_segmentation.main, few, seg150, []),
            ("segmentation NUM_CLASS", run_segmentation.main, images,
             os.path.join(scene_dir, "segment"),
             ["--num_classes", str(NUM_CLASS)])):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with clocked_calls(torch, dpt_mod, ("dpt_forward",
                                            "init_params")) as fwd, \
                clocked_calls(torch, DT, ("write_depth",
                                          "resize_prediction")) as host:
            run_cli(main, ["-i", src, "-o", out, *extra], torch)
        k = len(os.listdir(src))
        res[tag] = dict(s=time.perf_counter() - t1, fwd=fwd["dpt_forward"],
                        init=sum(fwd["init_params"]),
                        resize=sum(host["resize_prediction"]),
                        write=sum(host["write_depth"]), n=k)
        check(len(fwd["dpt_forward"]) == k, f"(l.4) {tag}: "
              f"{len(fwd['dpt_forward'])} forwards for {k} images")
    for name in names:
        with Image.open(os.path.join(scene_dir, "depth", name)) as im:
            d = np.asarray(im)
        check(im.mode.startswith("I") and d.shape == (H, W) and d.max() > 0,
              f"(l.4) depth/{name}: {im.mode} {d.shape}")
        for folder, ncls in ((os.path.join(scene_dir, "segment"),
                              NUM_CLASS), (seg150, 150)):
            p = os.path.join(folder, name)
            if folder == seg150 and name not in names[:SEG150_VIEWS]:
                continue
            with Image.open(p) as im:
                s = np.asarray(im)
            check(s.dtype == np.uint8 and s.shape == (H, W)
                  and int(s.max()) < ncls, f"(l.4) {p}: {s.dtype} {s.shape}")
            check(os.path.exists(p[:-4] + "_overlay.png"), f"(l.4) {p}")
    for tag, r in res.items():
        k = r["n"]
        rest = r["s"] - r["init"] - sum(r["fwd"]) - r["resize"] - r["write"]
        print(f"dpt CLI (l.4) [{card}]: {tag}: {r['s']:.2f} s for {k} "
              f"{W}x{H} images ({(r['s'] - r['init']) / k:.3f} s per image "
              f"after the model's init_params {r['init']:.2f} s); an "
              f"image: dpt_forward {sum(r['fwd']) / k * 1e3:.1f} ms (the "
              f"first {r['fwd'][0] * 1e3:.1f}), bicubic resizes "
              f"{r['resize'] / k * 1e3:.1f} ms, depth PNG writes "
              f"{r['write'] / k * 1e3:.1f} ms, the rest (reads, prepare, "
              f"the class argmax, class and overlay PNGs) "
              f"{rest / k * 1e3:.1f} ms")

    out = os.path.join(work, "prep_model")
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    t1 = time.perf_counter()
    run_cli(train_cli.main, [
        "-s", scene_dir, "-m", out, "-r", "1", "--using_depth",
        "--depth_loss_choice",
        "L1_loss", "--using_seg", "--num_class", str(NUM_CLASS),
        "--disable_gui_server", "--iterations_override",
        str(PREP_TRAIN_ITERS)], torch)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t1
    launches = dict(_kernels.launch_counts)
    check(all(launches[k] == PREP_TRAIN_ITERS for k in PREP_KERNELS),
          f"(l.4) training: K3, K1, K2 and K4 not once an iteration: "
          f"{json.dumps(launches)}")
    for f in ("cfg_args", "train_log.jsonl", "cameras.json", "input.ply",
              os.path.join("point_cloud", f"iteration_{PREP_TRAIN_ITERS}",
                           "point_cloud.ply")):
        check(os.path.exists(os.path.join(out, f)), f"(l.4) training: no {f}")
    with open(os.path.join(out, "train_log.jsonl")) as f:
        log = [json.loads(x) for x in f]
    check(log and all(math.isfinite(r["loss"]) for r in log),
          f"(l.4) training: loss {log}")
    print(f"dpt CLI (l.4) [{card}]: training on the DPT depth and segment "
          f"maps, {PREP_TRAIN_ITERS} iterations at {W}x{H} in {t_train:.2f} "
          f"s (scene load included), launches {json.dumps(launches)}, "
          f"train_log {json.dumps(log)}; phase "
          f"{time.perf_counter() - t0:.1f} s")


def phase_prep(torch, np, card, work):
    """(l) in order (l.1) to (l.4), on phase (h)'s scene and PLY."""
    t0 = time.perf_counter()
    scene_dir = os.path.join(work, "render_scene")
    ply = os.path.join(work, "render_model", "point_cloud", "iteration_1",
                       "point_cloud.ply")
    prep = os.path.join(work, "prep")
    os.makedirs(prep)
    phase_prep_host(torch, np, card, scene_dir, prep)
    phase_native_io(np, card, ply, prep)
    rows = phase_dpt(torch, np, card, scene_dir)
    phase_dpt_clis(torch, np, card, scene_dir, prep)
    print(f"prep (l) [{card}]: phase {time.perf_counter() - t0:.1f} s")
    return rows



PRE_SLOTS = (524288, 4194304)
PRE_ENTRY = re.compile(
    r"preprocess_(forward|backward)_kernelILi(\d)ELb([01])ELb([01])E")


def preprocess_case(torch, model, cam, slots):
    """K5's inputs at ``slots``: the asset's rows then dead slots in a model
    of TRAIN_CAPACITY slots, repeated to ``slots``; the Geometry of bench.py's
    camera; a cotangent of depths, means2d, conic and rgb from a generator
    seeded 5."""
    from gsplat_tpu_torch.core import transforms as T
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    dev = model.device
    tm = train_model(torch, model)
    p = tm.params
    reps = slots // TRAIN_CAPACITY

    def rep(x):
        return x.repeat((reps,) + (1,) * (x.dim() - 1)).contiguous()

    args = [rep(x) for x in (
        p.xyz, T.scaling_activation(p.scaling), p.rotation,
        T.opacity_activation(p.opacity[:, 0]), tm.get_features)]
    args += [None] + [torch.as_tensor(m, device=dev) for m in (
        cam.world_view_transform, cam.full_proj_transform, cam.camera_center)]
    geo = pre_lib.geometry(3, cam.tan_fovx, cam.tan_fovy, W, H)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cot = [torch.randn(shape, generator=gen, device=dev)
           for shape in ((slots,), (slots, 2), (slots, 3), (slots, 3))]
    return args, geo, cot


def preprocess_gaps(torch, fields, valid=None):
    """(max |diff| of each field, the absolute limit of each) of
    ``fields``, (name, kernel's, plain version's) triples: without
    ``valid``, K5's outputs, every entry equal (a NaN where the plain
    version has one); with it, K6's gradients on the ``valid`` slots, each
    entry within 1e-4 of itself plus 1e-4 of the field's median magnitude
    there.  Raises on the first field outside."""
    gaps, limits = {}, {}
    for name, a, b in fields:
        if valid is not None:
            a, b = a[valid], b[valid]
        diff = (a.float() - b.float()).abs()
        gaps[name] = float(torch.nan_to_num(diff, nan=0.0).max()) \
            if diff.numel() else 0.0
        if valid is None:
            bad = int((~((a == b) | (torch.isnan(a) & torch.isnan(b))))
                      .sum())
            check(bad == 0, f"K5: {name} differs from the plain version in "
                  f"{bad} entries (max |diff| {gaps[name]})")
        else:
            floor = 1e-4 * float(b.abs().median()) if b.numel() else 0.0
            limits[name] = floor
            over = int((~torch.isclose(a, b, rtol=1e-4, atol=floor)).sum())
            check(over == 0, f"K6: {over} {name} gradients outside rtol "
                  f"1e-4 + {floor:.3g} (max |diff| {gaps[name]})")
    return gaps, limits


def phase_preprocess(torch, card, model, cam, report, launches):
    """(m) K5 and K6 against their plain versions at PRE_SLOTS, timed on
    the device alone beside them and their byte bounds.  ``launches``: the
    main path's counts of each, which the kernel table's rows take.
    Returns those rows."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    from gsplat_tpu_torch.tools import workload as wl

    regs = _kernels.ptxas_entries(report, PRE_ENTRY)
    print("preprocess ptxas: " + "; ".join(
        f"{k[0]} degree {k[1]} sh {k[2]} cov {k[3]}: {r} registers, {sp} "
        "bytes spilled" for k, (r, sp) in sorted(regs.items())))
    check(len(regs) == 24 and all(sp == 0 for _, sp in regs.values()),
          "preprocess: an instantiation spills or is missing")
    rows = []
    for slots in PRE_SLOTS:
        args, geo, cot = preprocess_case(torch, model, cam, slots)
        m, sc, rot, op, sh, cov, vm, pm, cp = args
        _kernels.reset_launch_counts()
        got = pre_lib.preprocess_forward(*args, geo)
        torch.cuda.synchronize()
        check(_kernels.launch_counts["preprocess_forward"] == 1,
              "preprocess: K5 did not launch once")
        want = pre_lib.preprocess_forward_plain(*args, geo)
        names = ("depths", "means2d", "conic", "rgb", "radii",
                 "tiles_touched", "rect_min", "rect_max", "visible")
        errs, _ = preprocess_gaps(torch, zip(names, got, want))
        tiles = got[5]
        grads = pre_lib.preprocess_backward(m, sc, rot, sh, cov, vm, pm, cp,
                                            tiles, geo, *cot)
        plain = pre_lib.preprocess_backward_plain(m, sc, rot, sh, cov, vm, pm,
                                                  cp, tiles, geo, *cot)
        valid = tiles > 0
        fields = list(zip(("d_means3d", "d_scales", "d_rotations", "d_shs"),
                          grads, plain))
        for name, a, _ in fields:
            check(bool(torch.isfinite(a).all()), f"K6: non-finite {name}")
            check(not bool(a[~valid].any()), f"K6: a culled slot's {name}")
        gaps, limits = preprocess_gaps(torch, fields, valid)
        errs.update(gaps)
        nvalid = int(valid.sum())
        print(f"preprocess at {slots} slots ({nvalid} valid): K5 equal to "
              f"its plain version in every output, K6 within rtol 1e-4 and "
              f"the absolute limits {json.dumps(limits)} on the valid "
              f"slots, zero on the others; max |diff| {json.dumps(errs)}")

        def nbytes_of(xs):
            return sum(x.numel() * x.element_size() for x in xs
                       if x is not None and x.shape[0] == slots)

        fwd_bytes = nbytes_of(args) + nbytes_of(got)
        # K6 needs a valid slot's inputs, cotangents and tiles_touched and
        # writes its gradients; a dead slot needs only its tiles_touched
        # and writes zero rows
        out_row = nbytes_of(grads[:4]) // slots
        full_row = (nbytes_of((m, sc, rot, sh)) + nbytes_of(cot)) // slots \
            + 4 + out_row
        bwd_bytes = nvalid * full_row + (slots - nvalid) * (4 + out_row)
        for kernel, fn, plain_fn, nbytes, counter in (
                ("K5 preprocess_forward",
                 lambda: pre_lib.preprocess_forward(*args, geo),
                 lambda: pre_lib.preprocess_forward_plain(*args, geo),
                 fwd_bytes, "preprocess_forward"),
                ("K6 preprocess_backward",
                 lambda: pre_lib.preprocess_backward(
                     m, sc, rot, sh, cov, vm, pm, cp, tiles, geo, *cot),
                 lambda: pre_lib.preprocess_backward_plain(
                     m, sc, rot, sh, cov, vm, pm, cp, tiles, geo, *cot),
                 bwd_bytes, "preprocess_backward")):
            ms = [median_ms(fn, 20) for _ in range(2)]
            plain_ms = event_ms(plain_fn, 3, warmup=1)
            bound, by = wl.bound_ms(nbytes, 0)
            print(f"{kernel} [{card}] at {slots} slots: {ms[0]:.4f}, "
                  f"{ms[1]:.4f} ms on the device alone; plain version "
                  f"{plain_ms:.3f} ms; bound {bound:.4f} ms by {by} "
                  f"({nbytes} bytes, {nbytes / slots:.1f} a slot), "
                  f"{100 * bound / min(ms):.1f}% of it")
            rows.append({"name": kernel, "route": "cuda",
                         "source": "gsplat_tpu_torch/csrc/preprocess.cu",
                         "replaces": "none (XLA fusion of "
                                     "gsplat_tpu/ops/preprocess.py)",
                         "slots": slots, "launches": launches[counter],
                         "ms": min(ms), "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": by,
                         "library_ms": None,
                         "max_abs_err": max(errs.values())})
        del args, cot, got, want, grads, plain
        torch.cuda.empty_cache()
    return rows


# (n) SSIM: the asset's render against a seeded noisy copy of it, and the
# two images' ragged top-left corner
SSIM_SHAPES = {"1920x1080": (1080, 1920), "1777x1001": (1001, 1777)}
SSIM_ENTRY = re.compile(r"ssim_(forward|backward|mean)_kernel")


def phase_ssim(torch, card, img, report, launches):
    """(n) K7 and K8 (``csrc/ssim.cu``) on the asset's 1080p render
    (clamped to [0, 1]) against it with seeded noise added, at 1920x1080
    and on their 1777x1001 corner: K7's mean within 1e-6 relative of
    ``ssim_plain``'s, K8's gradient per entry within rtol 1e-4 plus 1e-4 of
    the plain gradient's largest magnitude, each bit-equal over two
    launches; at 1080p both timed on the device alone beside their
    operation bounds (``workload.ssim_bound``), their plain versions and the
    autograd chain of ``ssim_plain`` (the SSIM the step ran before them).
    ``launches``: the main path's counts of each.  Returns the kernel
    table's rows."""
    from gsplat_tpu_torch import _kernels
    from gsplat_tpu_torch.tools import workload as wl
    from gsplat_tpu_torch.train import losses as L
    t0 = time.perf_counter()
    regs = _kernels.ptxas_entries(report, SSIM_ENTRY)
    print("ssim (n) ptxas: " + "; ".join(
        f"{k[0]}: {r} registers, {sp} bytes spilled"
        for k, (r, sp) in sorted(regs.items())))
    check(len(regs) == 3 and all(sp == 0 for _, sp in regs.values()),
          "ssim (n): a kernel spills or is missing")
    gen = torch.Generator(device=img.device)
    gen.manual_seed(21)
    x = img.detach().clamp(0, 1).contiguous()
    y = (x + 0.05 * torch.randn(x.shape, generator=gen, device=x.device)
         ).clamp(0, 1)
    g = torch.tensor(-0.2, device=x.device)
    errs = {}
    for tag, (h, w) in SSIM_SHAPES.items():
        a, b = x[:, :h, :w].contiguous(), y[:, :h, :w].contiguous()
        got, want = L.ssim_forward(a, b), L.ssim_plain(a, b)
        rel = abs(float(got) - float(want)) / abs(float(want))
        check(rel <= 1e-6, f"ssim (n) {tag}: K7 {float(got)!r} against "
              f"the plain version's {float(want)!r} ({rel:.3g} relative)")
        d_got = L.ssim_backward(a, b, g)
        d_want = L.ssim_backward_plain(a, b, g)
        check(bool(torch.isfinite(d_got).all()), f"ssim (n) {tag}: K8 "
              "non-finite")
        floor = 1e-4 * float(d_want.abs().max())
        over = int((~torch.isclose(d_got, d_want, rtol=1e-4, atol=floor))
                   .sum())
        check(over == 0, f"ssim (n) {tag}: {over} K8 entries outside rtol "
              f"1e-4 + {floor:.3g}")
        check(torch.equal(got, L.ssim_forward(a, b))
              and torch.equal(d_got, L.ssim_backward(a, b, g)),
              f"ssim (n) {tag}: a second launch gave other bits")
        errs[tag] = {"ssim": float(got), "k7_rel": rel,
                     "k7_abs": abs(float(got) - float(want)),
                     "k8_max_abs": float((d_got - d_want).abs().max()),
                     "k8_atol": floor,
                     "k8_equal_share": float((d_got == d_want).float().mean())}
    print(f"ssim (n): K7 and K8 within their limits of the plain versions "
          f"and bit-equal over two launches: {json.dumps(errs)}")

    xg = x.clone().requires_grad_(True)

    def chain():
        torch.autograd.grad(L.ssim_plain(xg, y), xg, g)

    C, H_, W_ = x.shape
    rows, kernel_ms = [], {}
    for kernel, fn, plain_fn, backward, counter in (
            ("K7 ssim_forward", lambda: L.ssim_forward(x, y),
             lambda: L.ssim_plain(x, y), False, "ssim_forward"),
            ("K8 ssim_backward", lambda: L.ssim_backward(x, y, g),
             lambda: L.ssim_backward_plain(x, y, g), True, "ssim_backward")):
        ms = [median_ms(fn, 20) for _ in range(2)]
        plain_ms = event_ms(plain_fn, 5, warmup=1)
        bound, by, nbytes, nops = wl.ssim_bound(C, H_, W_, backward)
        kernel_ms[counter] = min(ms)
        print(f"{kernel} [{card}] at {W_}x{H_}: {ms[0]:.4f}, {ms[1]:.4f} ms "
              f"on the device alone; plain version {plain_ms:.3f} ms; bound "
              f"{bound:.4f} ms by {by} ({nops} operations, {nbytes} bytes), "
              f"{100 * bound / min(ms):.1f}% of it")
        rows.append({"name": kernel, "route": "cuda",
                     "source": "gsplat_tpu_torch/csrc/ssim.cu",
                     "replaces": "none (XLA fusion of "
                                 "gsplat_tpu/train/losses.py:33)",
                     "launches": launches[counter],
                     "ms": min(ms), "plain_ms": plain_ms,
                     "bound_ms": bound, "bound_by": by, "library_ms": None,
                     "max_abs_err": errs["1920x1080"]["k8_max_abs"
                                                      if backward
                                                      else "k7_abs"]})
    chain_ms = event_ms(chain, 5, warmup=1)
    print(f"ssim (n) [{card}]: ssim_plain and its autograd backward "
          f"{chain_ms:.3f} ms a call at {W_}x{H_}, against K7 + K8 "
          f"{sum(kernel_ms.values()):.4f} ms; phase "
          f"{time.perf_counter() - t0:.1f} s")
    return rows


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
    from gsplat_tpu_torch.models.gaussians import params_from_numpy
    from gsplat_tpu_torch.ops import binning as bin_lib
    from gsplat_tpu_torch.ops import composite_cuda as comp
    from gsplat_tpu_torch.ops import preprocess as pre_lib
    from gsplat_tpu_torch.ops import segment_reduce as seg_lib
    from gsplat_tpu_torch.ops.composite_ref import composite_reference
    from gsplat_tpu_torch.tools import workload as wl

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
    PTXAS["report"] = report
    lib = _kernels.lib()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc sm_90a, "
          f"{len(_kernels.SOURCES)} sources in parallel)")
    for line in report.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("==")):
            print("  ptxas:", line.strip())
    print(f"K2 CTAs per SM: {json.dumps(k2_occupancy(comp))}")
    print(f"K1 CTAs per SM: {json.dumps(k1_occupancy(comp))}; ptxas at "
          "C = 3, 5, 7 (f32, quad, packed, packed quad): " + "; ".join(
              f"C={C} form {b}: {k1_ptxas(C, b)}" for C in (3, 5, 7)
              for b in ((0, 1, 2, 3) if C == 3 else (0, 1, 6, 7))))
    k3_regs = _kernels.ptxas_entries(
        report, re.compile(r"(expand_extras_kernel|expand_kernel)(?!ILb1E)"))
    print(f"K3 CTAs per SM: {lib.gsplat_expand_occupancy(0)}, K3x: "
          f"{lib.gsplat_expand_occupancy(8)}; ptxas: " + "; ".join(
              f"{k[0]}: {r} registers, {sp} bytes spilled"
              for k, (r, sp) in sorted(k3_regs.items())))
    tile_children = {shape: start_tile_child(*shape) for shape in TILE_SHAPES}
    par_work = tempfile.mkdtemp(prefix="chip_smoke_par_")
    atexit.register(shutil.rmtree, par_work, True)
    from gsplat_tpu_torch.parallel.multihost import free_port
    par_ranks = start_par_ranks(free_port(), par_work)
    wmap = {f"{x}x{y}": comp.warp_map_errors(x, y) for x, y in WARP_MAP_SHAPES}
    check(all(v == {"outside": 0, "misowned": 0} for v in wmap.values()),
          "the warp map K1 and K2 share disagrees with the cull's boxes: "
          + json.dumps(wmap))
    print("warp map: each pixel owned by one thread, inside its warp's box, "
          f"at tiles of {', '.join(wmap)}")

    # ---- 2. scene, binning and K1's inputs (tools.workload) ----------------
    w = wl.asset_workload(dev, pair_counts=False)
    sc = w.scene
    model, cam, pre, bins, feats, cap = (sc[k] for k in (
        "model", "cam", "pre", "bins", "feats", "cap"))
    pre_args = sc["pre_args"]
    P = model.capacity
    p = model.params
    gx, gy = w.grid_x, sc["grid_y"]
    num_tiles = gx * gy
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
    order_p = torch.sort(tile_p, stable=True)[1]
    for f, want in (("tile_id", tile_p[order_p]), ("gauss_id", gid_p[order_p]),
                    ("tile_start", src.tile_start)):
        check(torch.equal(getattr(bins, f), want),
              f"K3: binning {f} differs from the plain version")
    check(k3_bad == 0, f"K3: {k3_bad} slots differ from the plain version")
    check(not bool(bins.overflow), "K3: capacity overflow at 1080p")
    k3_part = check_k3_partition(torch, lib, bin_lib, k3_args, "asset")
    print(f"K3 expand: bit-equal to its plain version on {cap} slots "
          f"({S} sources, {int(bins.num_rendered)} instances, "
          f"{int(bins.num_padded)} padded); its partition equal to the plain "
          f"version's in all {k3_part.slot_start.shape[0]} CTAs")

    # ---- 3a. K3x (the extras form) and exact-cull binning -----------------
    k3x = phase_k3x(torch, card, bin_lib, pre, gx, gy, cap)
    phase_k3_handmade(torch, card, bin_lib, wl, dev, lib)

    # ---- 4. K1 against its plain version ----------------------------------
    C = w.C
    table, gid_sorted, starts, counts = w.table, w.gauss_id, w.starts, w.counts
    k1_args = w.k1_args
    packed_k = w.packed             # K1's output, from asset_workload
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
    print(f"K1 at C = {C}: {comp.forward_occupancy(C, C)} CTAs per SM, "
          f"{k1_ptxas(C, 0)}")

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
    w.pairs = wl.k1_pair_counts(*k1_args, packed_p[:, C + 1])
    w.culled = wl.k1_culled_pairs(*k1_args, packed_p[:, C + 1])
    tested, contributing, stopping = (w.pairs[k] for k in (
        "tested", "composited", "stopping"))
    print(f"K1 pairs: {tested} tested without the per-warp cull, "
          f"{contributing} composited, {stopping} stopping; after the cull "
          f"{json.dumps(w.culled)} ({time.perf_counter() - t0:.1f} s to "
          "count)")

    # ---- 5. K4 and K2 against their plain versions -------------------------
    k4 = phase_k4(torch, seg_lib, card, gid_sorted, P, comp.ATTR_BASE + C - 1)
    k2 = phase_k2(torch, comp, card, k1_args, packed_k, w.d_packed, P, C,
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
    renderer.render(cam, model, device=dev)    # the shape's capacity count
    torch.cuda.synchronize()
    _kernels.reset_launch_counts()
    out = renderer.render(cam, model, device=dev)
    torch.cuda.synchronize()
    launches = dict(_kernels.launch_counts)
    print(f"render: launches {json.dumps(launches)}")
    check(launches["expand"] == 1 and launches["composite_forward"] == 1
          and launches["preprocess_forward"] == 1
          and launches["preprocess_backward"] == 0,
          "render did not launch K5, K3 and K1 once each")
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

    # ---- 7b. exact-cull render against the plain one -----------------------
    phase_cull_render(torch, card, model, cam, cap)

    # ---- 8. the training path ---------------------------------------------
    train_launches, train_steps, thr, extent = phase_train(
        torch, np, card, cam, model, cap)

    # ---- 9. the Trainer at 1080p with exact cull, and the command line -----
    trainer_launches = phase_trainer(torch, np, card, model, thr, extent)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, work, True)
    _, cli_model = phase_cli(torch, np, card, work)
    cli_files = tree_files(cli_model)

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
        stage_ms[name] = event_ms(fn, 20)
        print(f"stage [{card}] {name}: {stage_ms[name]:.4f} ms")
    # main and other --fmad build of K1, alternated in this one run
    main_fmad = "false" if alt_fmad == "true" else "true"
    fmad_ms = {main_fmad: [stage_ms["K1 kernel alone"]], alt_fmad: []}
    for _ in range(2):
        fmad_ms[alt_fmad].append(event_ms(k1_alt, 20))
        fmad_ms[main_fmad].append(event_ms(
            lambda: comp.composite_forward(*k1_args), 20))
    print(f"K1 [{card}] --fmad={main_fmad} (main build): "
          f"{', '.join(f'{t:.4f}' for t in fmad_ms[main_fmad])} ms; "
          f"--fmad={alt_fmad}: "
          f"{', '.join(f'{t:.4f}' for t in fmad_ms[alt_fmad])} ms")
    k3_ms = median_ms(lambda: bin_lib.expand(*k3_args))
    print(f"K3 [{card}]: {k3_ms:.5f} ms on the device alone "
          f"(timing.median_ms); {stage_ms['K3 kernel alone']:.5f} ms a call "
          "back to back, host included (event_ms)")
    k3_plain_ms = event_ms(lambda: bin_lib.expand_plain(*k3_args), 10)
    k1_plain_ms = event_ms(lambda: comp.composite_forward_plain(
        *k1_args), 2, warmup=1)
    print(f"plain [{card}] K3 expand_plain: {k3_plain_ms:.4f} ms; "
          f"K1 composite_forward_plain: {k1_plain_ms:.2f} ms")
    print("clocks/power after timing: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit,"
         "temperature.gpu", "--format=csv,noheader"], check=True,
        capture_output=True, text=True).stdout.strip())

    # ---- 18. (m) preprocess: K5 and K6 against their plain versions -------
    pre_rows = phase_preprocess(torch, card, model, cam, report, {
        "preprocess_forward": launches["preprocess_forward"],
        "preprocess_backward": train_launches["preprocess_backward"]})

    # ---- 19. (n) SSIM: K7 and K8 against their plain versions -------------
    ssim_rows = phase_ssim(torch, card, out["render"], report, {
        k: train_launches[k] for k in ("ssim_forward", "ssim_backward")})

    # ---- 10. (e) the kernel probes of gsplat_tpu_torch/tools ---------------
    probe_rows = phase_probes(torch, card, w)

    # ---- 11. (f) the JAX trainer's default numerics: K1's and K2's forms ----
    form_kernel_rows = phase_form_kernels(torch, card, w)
    form_launches = phase_form_paths(torch, np, card, w)

    # ---- 12. (g) K1 and K2 at 16x16 tiles ----------------------------------
    phase_tiles(card, tile_children)

    # ---- 13. (h) the render and evaluation command lines at 1080p ----------
    phase_render_cli(torch, np, card, model, work, cli_model)

    # ---- 14. (i) the appearance embedding and the viewer socket at 1080p ---
    phase_appearance_step(torch, np, card, w)
    phase_appearance_trainer(torch, np, card, w, model, extent)
    phase_appearance_cli(torch, np, card, work)

    # ---- 15. (j) multi-GPU training and rendering on the one card ---------
    t0 = time.perf_counter()
    phase_par_slices(torch, np, card, model)
    phase_par_nccl(torch, np, card, cam, model, cap)
    phase_par_ranks(torch, np, card, model, par_ranks, par_work)
    phase_par_cli(torch, np, card, work, cli_files)
    print(f"par (j): phase {time.perf_counter() - t0:.1f} s")

    # ---- 16. (k) the viewers, the editor and the render backends ----------
    phase_viewing(torch, np, card, model, cam, bins, work)

    # ---- 17. (l) data prep, native I/O, DPT and its CLIs into training ----
    phase_prep(torch, np, card, work)

    # bounds: each input read once, each output written once
    k3_bound, k3_by, k3_bytes, k3_ops = wl.expand_bound(S, cap)
    k1_bytes = (table.numel() * 4 + int(counts.sum()) * 4 + 2 * 4 * num_tiles
                + packed_k.numel() * 4)
    k1_ops = wl.k1_ops(w.culled, C)
    k1_exps = w.culled["live"]
    k1_bound, k1_by = wl.bound_ms(k1_bytes, k1_ops, nexp=k1_exps)
    print(f"K3 bound: {k3_bytes} bytes, {k3_ops} ops (not counted, a cost "
          f"of its design: the {k3_part.probes} offsets its partition "
          f"probes, {4 * k3_part.probes} bytes); K1 bound: {k1_bytes} "
          f"bytes, {k1_ops} ops ({wl.K1_TEST_OPS} per live pair after the "
          f"per-warp cull, {wl.K1_STEP_OPS} more per composited or stopping "
          f"pair, {1 + 2 * C} more per composited pair; the cull's "
          f"{wl.CULL_INSTANCE_OPS} per instance a tile needs, "
          f"{wl.CULL_WARP_OPS} per instance and warp, {wl.CULL_EDGE_OPS} more "
          f"where the warp's box does not hold the mean), {k1_exps} "
          f"exponentials (one a live pair); bound {k1_bound:.5f} ms by "
          f"{k1_by}")
    kernels = [
        {"name": "K3 expand", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/expand.cu",
         "replaces": "gsplat_tpu/ops/binning.py:84",
         "launches": launches["expand"], "max_abs_err": float(k3_err),
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None},
        {"name": "K1 composite_forward", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/composite_fwd.cuh",
         "replaces": "gsplat_tpu/ops/composite_pallas.py:247",
         "launches": launches["composite_forward"],
         "max_abs_err": k1_err, "ms": stage_ms["K1 kernel alone"],
         "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None},
        {"name": "K2 composite_backward", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/composite_bwd.cuh",
         "replaces": "gsplat_tpu/ops/composite_pallas.py:356",
         "launches": train_launches["composite_backward"], **k2},
        {"name": "K4 segment_sum_sorted", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/segsum.cu",
         "replaces": "gsplat_tpu/ops/segment_reduce.py:38",
         "launches": train_launches["segment_sum"], **k4},
        {"name": "K3 expand (extras)", "route": "cuda",
         "source": "gsplat_tpu_torch/csrc/expand.cu",
         "replaces": "gsplat_tpu/ops/binning.py:84 (n_extra > 0)",
         "launches": trainer_launches["expand_extras"], **k3x},
        *probe_rows,
        *form_rows(form_kernel_rows, form_launches),
        *pre_rows,
        *ssim_rows,
    ]
    print(f"launches: K3 and K1 from the one render, K2 and K4 from the "
          f"{train_steps} training steps (K3 and K1 also ran "
          f"{train_launches['expand']} and "
          f"{train_launches['composite_forward']} times there), K3x from "
          f"the {TRAINER_ITERS} Trainer iterations with exact cull, P1 to P4 "
          "from the six entry modules of gsplat_tpu_torch.tools (phase e)")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tile"] and len(sys.argv) == 3:
        sys.exit(tile_main(*map(int, sys.argv[2].split("x"))))
    if sys.argv[1:2] == ["--rank"] and len(sys.argv) == 6:
        sys.exit(rank_main(*map(int, sys.argv[2:5]), sys.argv[5]))
    sys.exit(main())
