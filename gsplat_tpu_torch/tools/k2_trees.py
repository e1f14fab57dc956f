"""Time K1, K2, K3, K3x or K4 built from other trees of
``gsplat_tpu_torch/csrc`` against this one's on the card, alternated, at
the 1080p asset.

    python -m gsplat_tpu_torch.tools.k2_trees [--kernel k1|k2|k3|k3x|k4] \
        --tree old=<csrc dir> [--tree <name>=<csrc dir> ...] \
        [--forms f32,quad,packed,packed_quad]

builds the kernel's sources of every tree, and of this package as ``new``,
with the build's flags (``_kernels.NVCC_FLAGS``) into a library of its own,
all at once, and prints each tree's ptxas registers and spills of the kernel
at the asset's width; checks each tree's output:

- K2 (``composite_bwd.cu``, ``composite_bwd_forms.cu``): each form's rows
  against the plain version by chip_smoke.py's rule
  (``workload.compare_form_rows``);
- K1 (``composite_fwd.cu``, ``composite_fwd_forms.cu``): each form's
  [T, C+2, TILE_PIX] output bit-equal to this tree's in all C + 2 rows, and
  this tree's within chip_smoke.py's tolerances of the plain version, and
  the same for the f32 form on the heaviest tile alone ("heaviest", the
  longest walk); it prints the pairs K1 tests before and after its per-warp
  cull (``workload.k1_pair_counts``, ``k1_culled_pairs``);
- K4 (``segsum.cu``): the sums of phase 5's inputs (the asset's instance
  list sorted by gaussian id, [I, 12] rows from a generator seeded 4)
  bit-equal to this tree's, and this tree's within tolerance of
  ``index_add_``;
- K3 and K3x (``expand.cu``), in place of the forms two inputs: "asset",
  the asset's cull="none" sources at the renderer's capacity (K3) or its
  exact-cull stage-A sources (K3x), and "handmade",
  ``workload.k3_full_sources``; this tree's outputs bit-equal to
  ``binning.expand_plain``'s, every other tree's to this tree's; it prints
  after the medians each input's bound (``workload.expand_bound``) with
  the offsets K3's partition probes beside it, the CTAs per SM of the
  trees that report them, each tree's back-to-back mean
  (``timing.event_ms``, host included) and two ``fill_`` calls of [I]
  int32, a floor for K3's writes;

then times each form with the trees in order, reversed, in order and
reversed (``timing.median_ms`` of the C entry's launch and what the wrapper
allocates around it) and prints every time beside the card's name and power
limit.  For a change, unpack the parent's sources into a directory git
ignores (``git archive HEAD gsplat_tpu_torch/csrc | tar -x -C
_proof/parent``) and pass ``--tree old=_proof/parent/gsplat_tpu_torch/csrc``.
Needs ``nvcc`` and the card; without a card ``main`` raises.
"""
from __future__ import annotations

import argparse
import ctypes
import functools
import math
import os
import re
import subprocess
import tempfile
from typing import Callable, NamedTuple, Optional

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import binning as bin_lib
from gsplat_tpu_torch.ops import composite_cuda as comp
from gsplat_tpu_torch.tools import timing
from gsplat_tpu_torch.tools import workload as wl

FORMS = ("f32", "quad", "packed", "packed_quad")
KERNELS = {
    # sources, C entries, the ptxas name of the kernel at the asset's width
    # (its form bits captured)
    "k1": (("composite_fwd.cu", "composite_fwd_forms.cu"),
           ("gsplat_composite_forward", "gsplat_composite_forward_form"),
           re.compile(r"composite_forward(?:_form)?_kernelILi7ELi0ELi(\d)E")),
    "k2": (("composite_bwd.cu", "composite_bwd_forms.cu"),
           ("gsplat_composite_backward", "gsplat_composite_backward_form"),
           re.compile(r"composite_backward_kernelILi7ELi0ELi(\d)E")),
    "k4": (("segsum.cu",), ("gsplat_segment_sum",),
           re.compile(r"segsum_kernel|segment_sum_kernelILi12E")),
    # K3 and K3x, keyed by the kernel's name
    "k3": (("expand.cu",), ("gsplat_expand",),
           re.compile(r"(expand_extras_kernel|expand_kernel)(?!ILb1E)")),
    "k3x": (("expand.cu",), ("gsplat_expand_extras",),
            re.compile(r"(expand_extras_kernel|expand_kernel)(?!ILb1E)")),
}
# K4's entry before it took a scratch for its segment bounds
_K4_OLD = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,) * 2


def build(trees: dict, out_dir: str, kernel: str = "k2") -> dict:
    """{name: (ctypes library, {form bits: ptxas line})}, compiled in
    parallel."""
    sources, entries, pattern = KERNELS[kernel]
    procs = {}
    for name, csrc in trees.items():
        so = os.path.join(out_dir, f"{kernel}_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-I", csrc,
             "-shared", *[os.path.join(csrc, s) for s in sources], "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        report, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for tree {name}\n{report}")
        regs = {k[0] if pattern.groups else "0":
                f"{r} registers, {sp} bytes spill stores"
                for k, (r, sp) in _kernels.ptxas_entries(report,
                                                         pattern).items()}
        lib = ctypes.CDLL(so)
        for fn in entries:
            getattr(lib, fn).argtypes = _kernels.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        if kernel == "k4" and not hasattr(lib, "gsplat_segment_sum_scratch"):
            lib.gsplat_segment_sum.argtypes = _K4_OLD
        libs[name] = (lib, regs)
    return libs


class Cases(NamedTuple):
    """What ``main`` checks and times for one kernel."""
    workload: str       # the workload's name
    cases: dict         # {form: (launcher of a library, check of its output)}
    # report lines after the times, from {tree: (library, ptxas)}, or None
    notes: Optional[Callable] = None


def _k2_cases(workload, forms, dev):
    """K2's forms."""
    w = wl.load_workload(workload, dev)
    C, Cg = w.C, w.Cg
    cases = {}
    for f in forms:
        form = wl.form_of(f)
        table = wl.form_table(w.table, Cg, form)
        packed = comp.composite_forward(table, w.gauss_id, w.starts,
                                        w.counts, w.grid_x, form, Cg)
        args = (table, w.gauss_id, w.starts, w.counts, w.grid_x, packed,
                w.d_packed, Cg, form)
        want = comp.composite_backward_plain(*args)
        width = comp.ATTR_BASE + ((Cg + 1) // 2 if form.feat_packed else Cg)

        def launcher(lib, form=form, table=table, packed=packed, f=f,
                     width=width):
            def run():
                d = torch.zeros((w.gauss_id.shape[0], width),
                                dtype=torch.float32, device=dev)
                args = (table.data_ptr(), table.shape[0], C, Cg,
                        w.gauss_id.data_ptr(), w.starts.data_ptr(),
                        w.counts.data_ptr(), w.starts.shape[0], w.grid_x,
                        comp.TILE_X, comp.TILE_Y, packed.data_ptr(),
                        w.d_packed.data_ptr(), d.data_ptr(),
                        _kernels.stream_of(d))
                err = (lib.gsplat_composite_backward(*args) if form == comp.F32
                       else lib.gsplat_composite_backward_form(form.bits,
                                                               *args))
                if err != 0:
                    raise RuntimeError(f"K2 {f}: CUDA error {err}")
                return d
            return run

        def check(name, got, ref, want=want, form=form, f=f):
            err, worst, bad = wl.compare_form_rows(got, want, Cg,
                                                   form.feat_packed)
            if bad:
                raise RuntimeError(f"K2 {f} of tree {name}: {bad} values "
                                   f"outside the tolerance (worst column "
                                   f"{worst:.3g})")
            same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            return (f"within tolerance of the plain version (max |diff| "
                    f"{err:.3g}, worst column {worst:.2e} of its largest); "
                    f"bit-equal to this tree's: {same}")
        cases[f] = (launcher, check)
    return Cases(w.name, cases)


def _k1_cases(workload, forms, dev):
    """K1's forms: bit-equal to this tree's output, which is held to the
    plain version by chip_smoke.py's tolerances; and "heaviest", the f32 form
    on the tile with the most instances alone (the other tiles' counts 0):
    the longest walk, which bounds the kernel.  Prints the pairs K1 tests
    before and after its per-warp cull."""
    w = wl.load_workload(workload, dev)
    C, Cg = w.C, w.Cg
    before = w.pairs or wl.k1_pair_counts(*w.k1_args, w.packed[:, C + 1])
    after = wl.k1_culled_pairs(*w.k1_args, w.packed[:, C + 1])
    print(f"k1_trees: pairs K1 tests on the {w.name} workload: "
          f"{before['tested']} before the per-warp cull (each pixel up to its "
          f"own stop); after it {after['tested']} in "
          f"{after['warp_instances']} warp-instances (a warp's pixels up to "
          f"its last pixel's stop), {after['live']} of them of pixels not "
          "yet done")
    heavy = torch.zeros_like(w.counts)
    top = int(torch.argmax(w.counts))
    heavy[top] = w.counts[top]
    cases = {}
    for f in (*forms, "heaviest"):
        counts = heavy if f == "heaviest" else w.counts
        form = wl.form_of("f32" if f == "heaviest" else f)
        table = wl.form_table(w.table, Cg, form)
        k1 = (table, w.gauss_id, w.starts, counts, w.grid_x, form, Cg)
        plain = comp.composite_forward_plain(*k1)

        def launcher(lib, form=form, table=table, f=f, counts=counts):
            def run():
                out = torch.empty((w.starts.shape[0], C + 2, comp.TILE_PIX),
                                  dtype=torch.float32, device=dev)
                tail = (w.gauss_id.data_ptr(), w.starts.data_ptr(),
                        counts.data_ptr(), w.starts.shape[0], w.grid_x,
                        comp.TILE_X, comp.TILE_Y, out.data_ptr(),
                        _kernels.stream_of(out))
                err = (lib.gsplat_composite_forward(
                    table.data_ptr(), table.shape[0], C, *tail)
                    if form == comp.F32 else
                    lib.gsplat_composite_forward_form(
                        form.bits, table.data_ptr(), table.shape[0], C,
                        Cg if form.feat_packed else C, *tail))
                if err != 0:
                    raise RuntimeError(f"K1 {f}: CUDA error {err}")
                return out
            return run

        def check(name, got, ref, plain=plain, f=f):
            if name == "new":
                d = (got[:, :C + 1] - plain[:, :C + 1]).abs()
                over = int((d > 3e-4).sum())   # depth's tolerance, the widest
                nc = int((got[:, C + 1] != plain[:, C + 1]).sum())
                if over or nc:
                    raise RuntimeError(f"K1 {f} of this tree: {over} values "
                                       f"past 3e-4 of the plain version, "
                                       f"n_contrib differs at {nc} pixels")
                return (f"within tolerance of the plain version (max |diff| "
                        f"{float(d.max()):.3g}, n_contrib equal)")
            same = torch.equal(got.view(torch.int32), ref.view(torch.int32))
            if not same:
                rows = (got != ref).any(dim=2).any(dim=0).nonzero().flatten()
                raise RuntimeError(f"K1 {f} of tree {name}: not bit-equal to "
                                   f"this tree's (rows {rows.tolist()})")
            return f"bit-equal to this tree's in all {C + 2} rows"
        cases[f] = (launcher, check)
    return Cases(w.name, cases)


def _k4_cases(workload, forms, dev):
    """K4 ("f32") at chip_smoke.py phase 5's inputs; ``forms`` unused."""
    w = wl.load_workload(workload, dev)
    P = w.table.shape[0]
    R = comp.ATTR_BASE + w.C - 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    vals = torch.randn((w.gauss_id.shape[0], R), generator=gen, device=dev)
    sids, perm = torch.sort(w.gauss_id, stable=True)
    idx = w.gauss_id.clamp(0, P).long()
    lib_out = torch.zeros((P + 1, R), device=dev).index_add_(0, idx, vals)[:P]
    longest = int(torch.bincount(sids[sids < P].long(), minlength=1).max())

    def launcher(lib):
        scratch_fn = getattr(lib, "gsplat_segment_sum_scratch", None)

        def run():
            out = torch.empty((P, R), dtype=torch.float32, device=dev)
            head = (vals.data_ptr(), sids.data_ptr(), perm.data_ptr(),
                    vals.shape[0], R, P)
            if scratch_fn is None:
                err = lib.gsplat_segment_sum(*head, out.data_ptr(),
                                             _kernels.stream_of(out))
            else:
                scratch = torch.empty(scratch_fn(P), dtype=torch.int32,
                                      device=dev)
                err = lib.gsplat_segment_sum(*head, scratch.data_ptr(),
                                             out.data_ptr(),
                                             _kernels.stream_of(out))
            if err != 0:
                raise RuntimeError(f"K4: CUDA error {err}")
            return out
        return run

    def check(name, got, ref):
        if name == "new":
            # chip_smoke.py phase 5's tolerance: float32 sums in another order
            tol = 1e-5 * max(1.0, math.sqrt(longest)) * 8
            err = float((got - lib_out).abs().max())
            if err > tol:
                raise RuntimeError(f"K4 of this tree: {err:.3g} from "
                                   f"index_add_, tolerance {tol:.3g}")
            return (f"within {tol:.3g} of index_add_ (max |diff| {err:.3g}; "
                    f"{P} segments, the longest {longest} rows)")
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise RuntimeError(f"K4 of tree {name}: not bit-equal to this "
                               "tree's")
        return "bit-equal to this tree's"
    return Cases(w.name, {"f32": (launcher, check)})


def _k3_cases(workload, forms, dev, n_extra):
    """K3 (``n_extra`` 0) or K3x (8), in place of the forms two inputs:
    "asset", the asset's cull="none" sources at the renderer's capacity
    (K3) or its exact-cull stage-A sources at their row capacity (K3x);
    "handmade", ``workload.k3_full_sources``.  This tree's outputs bit-equal
    to ``expand_plain``'s, every other tree's to this tree's.  Its notes:
    each input's bound (``workload.expand_bound``; K3's partition probes
    beside it, a cost of the design), the CTAs per SM of the trees that
    report them, each tree's back-to-back mean (``timing.event_ms``, host
    included) and two ``fill_`` calls of [I] int32, a floor for K3's
    writes."""
    if workload != "asset":
        raise ValueError("K3 and K3x run on the asset's sources")
    # the asset's binning alone, not K1's pairs
    w = wl.asset_workload(dev, pair_counts=False)
    sc = w.scene
    gx, gy, cap, pre = w.grid_x, sc["grid_y"], sc["cap"], sc["pre"]
    if n_extra == 0:
        src = bin_lib.expansion_sources(pre, gx, gy, 128)
        asset = (src.offsets, src.meta, src.gid, cap, src.rw_bits, gx,
                 gx * gy)
        asset_extras = ()
    else:
        rs = bin_lib.row_sources(pre, gx, gy, 128)
        asset = (rs.offsets, rs.meta, rs.gid, bin_lib.row_capacity(cap),
                 bin_lib.meta_layout(gx, gx * gy, 128)[1], gx, gy)
        asset_extras = rs.extras
    hand = wl.k3_full_sources(dev)
    inputs = {"asset": (asset, asset_extras),
              "handmade": (hand.args(wl.K3_FULL_I),
                           hand.extras if n_extra else ())}
    cases = {}
    for case, (args, extras) in inputs.items():
        want = bin_lib.expand_plain(*args, extras=extras)

        def launcher(lib, args=args, extras=extras, case=case):
            offsets, meta, gid, I, rw_bits, grid_x, num_tiles = args
            head = (offsets.data_ptr(), meta.data_ptr(), gid.data_ptr())
            tail = (offsets.shape[0], I, rw_bits, grid_x, num_tiles)

            def run():
                out = (torch.empty(I, dtype=torch.int32, device=dev),
                       torch.empty(I, dtype=torch.int32, device=dev))
                if n_extra == 0:
                    err = lib.gsplat_expand(
                        *head, *tail, *(o.data_ptr() for o in out),
                        _kernels.stream_of(offsets))
                else:
                    out += (torch.empty((n_extra, I), dtype=torch.float32,
                                        device=dev),)
                    err = lib.gsplat_expand_extras(
                        *head, extras.data_ptr(), *tail, n_extra,
                        *(o.data_ptr() for o in out),
                        _kernels.stream_of(offsets))
                if err != 0:
                    raise RuntimeError(f"K3 {case}: CUDA error {err}")
                return out
            return run

        def check(name, got, ref, want=want, case=case, args=args):
            other, what = ((want, "the plain version") if name == "new"
                           else (ref, "this tree's"))
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(got, other)):
                raise RuntimeError(f"K3 {case} of tree {name}: not "
                                   f"bit-equal to {what}")
            return (f"bit-equal to {what} in all {len(got)} outputs (S "
                    f"{args[0].shape[0]}, I {args[3]}, offsets up to "
                    f"{int(args[0].max())})")
        cases[case] = (launcher, check)

    def notes(libs):
        lines = []
        for case, (args, _) in inputs.items():
            offsets, I = args[0], args[3]
            ms, by, nbytes, nops = wl.expand_bound(offsets.shape[0], I,
                                                   n_extra)
            line = (f"{case} bound {ms:.5f} ms ({by}; {nbytes} bytes, {nops} "
                    "operations)")
            if n_extra == 0:
                items = libs["new"][0].gsplat_expand_items()
                probes = bin_lib.expand_partition_plain(offsets, I,
                                                        items).probes
                line += (f"; not in it, a cost of the design: {probes} "
                         f"offsets the partition probes at {items} items "
                         "per CTA")
            lines.append(line)
        for name, (lib, _) in libs.items():
            occ = getattr(lib, "gsplat_expand_occupancy", None)
            if occ:
                lines.append(f"{name} CTAs per SM: K3 {occ(0)}, K3x {occ(8)}")
        # the back-to-back mean, which PERF.md carried before (host
        # included); and a floor for the writes: torch's fill_ of K3's two
        # outputs
        for name, (lib, _) in libs.items():
            lines.append(f"{name} event_ms " + " ".join(
                f"{case} {timing.event_ms(launcher(lib), 20):.5f}"
                for case, (launcher, _) in cases.items()))
        lines.append("two fill_ of [I] int32 " + " ".join(
            f"{case} " + format(timing.median_ms(lambda I=args[3]: [
                torch.empty(I, dtype=torch.int32, device=dev).fill_(0)
                for _ in range(2)]), ".5f")
            for case, (args, _) in inputs.items()))
        return lines
    return Cases(w.name, cases, notes)


CASES = {"k1": _k1_cases, "k2": _k2_cases, "k4": _k4_cases,
         "k3": functools.partial(_k3_cases, n_extra=0),
         "k3x": functools.partial(_k3_cases, n_extra=8)}


def main(trees=None, forms=FORMS, device="cuda", workload="asset",
         kernel="k2"):
    """Build, check and time ``kernel`` of ``trees`` ({name: csrc dir}) and
    of this package's sources (``new``).  Returns {name: {form: [ms, ...]}}."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {', '.join(KERNELS)}")
    dev = timing.cuda_device(device)
    card = timing.card_line()
    trees = {"new": _kernels.CSRC_DIR, **(trees or {})}
    spec = CASES[kernel](workload, forms, dev)
    forms = tuple(spec.cases)

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(trees, tmp, kernel)
        names = list(libs)
        for f in forms:
            launcher, check = spec.cases[f]
            ref = None
            for name in names:      # "new" first: the others meet its output
                got = launcher(libs[name][0])()
                torch.cuda.synchronize()
                ref = got if name == "new" else ref
                print(f"{kernel}_trees: {name} {f} {check(name, got, ref)}")
        for name, (_, regs) in libs.items():
            print(f"{kernel}_trees: {name} ({trees[name]}) ptxas: "
                  + "; ".join(f"form {b}: {r}" if b.isdigit() else
                              f"{b}: {r}" for b, r in sorted(regs.items())))
        ms = {n: {f: [] for f in forms} for n in names}
        for order in (names, names[::-1], names, names[::-1]):
            for n in order:
                for f in forms:
                    ms[n][f].append(timing.median_ms(
                        spec.cases[f][0](libs[n][0]), 10))
        notes = spec.notes(libs) if spec.notes else []
    print(f"{kernel}_trees: {kernel.upper()} on the {spec.workload} workload "
          f"[{card}], median ms of 10 launches, trees alternated (in order, "
          "reversed, twice)")
    for n in names:
        print(f"  {n:12s} " + "  ".join(
            f"{f} " + " ".join(f"{t:.5f}" for t in ms[n][f]) for f in forms))
    for line in notes:
        print(f"{kernel}_trees: {line}")
    return ms


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="k2", choices=tuple(KERNELS))
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=CSRC", help="another tree's csrc directory")
    ap.add_argument("--forms", default=",".join(FORMS))
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    main(trees, tuple(args.forms.split(",")), kernel=args.kernel)


if __name__ == "__main__":
    cli()
