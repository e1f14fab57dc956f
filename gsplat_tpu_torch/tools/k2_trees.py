"""Time K2 built from other trees of ``gsplat_tpu_torch/csrc`` against this
one's on the card, alternated, at the 1080p asset.

    python -m gsplat_tpu_torch.tools.k2_trees --tree old=<csrc dir> \
        [--tree <name>=<csrc dir> ...] [--forms f32,quad,packed,packed_quad]

builds ``composite_bwd.cu`` and ``composite_bwd_forms.cu`` of every tree,
and of this package as ``new``, with the build's flags
(``_kernels.NVCC_FLAGS``) into a library of its own, all at once; holds
each tree's rows in each form against the plain version by chip_smoke.py's
rule (``workload.compare_form_rows``); then times each form with the trees
in order, reversed, in order and reversed (``timing.median_ms`` of the C
entry's launch and the zero fill of its rows, as the wrapper does them),
and prints every time beside the card's name and power limit, with each
tree's ptxas registers and spills of the C = 7 kernels.  For a K2 change,
unpack the parent's sources into a directory git ignores
(``git archive HEAD gsplat_tpu_torch/csrc | tar -x -C _proof/parent``) and
pass ``--tree old=_proof/parent/gsplat_tpu_torch/csrc``.  Needs ``nvcc``
and the card; without a card ``main`` raises.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import tempfile

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.ops import composite_cuda as comp
from gsplat_tpu_torch.tools import timing
from gsplat_tpu_torch.tools import workload as wl

FORMS = ("f32", "quad", "packed", "packed_quad")
ENTRIES = ("gsplat_composite_backward", "gsplat_composite_backward_form")
_C7 = re.compile(r"composite_backward_kernelILi7ELi0ELi(\d)E")


def build(trees: dict, out_dir: str) -> dict:
    """{name: (ctypes library, {form bits: ptxas line})}, compiled in
    parallel."""
    procs = {}
    for name, csrc in trees.items():
        so = os.path.join(out_dir, f"k2_{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_kernels.find_nvcc(), *_kernels.NVCC_FLAGS, "-I", csrc,
             "-shared", os.path.join(csrc, "composite_bwd.cu"),
             os.path.join(csrc, "composite_bwd_forms.cu"), "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        report, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for tree {name}\n{report}")
        lines = report.splitlines()
        regs = {}
        for i, line in enumerate(lines):
            m = _C7.search(line)
            if m and "Compiling entry" in line:
                regs[int(m[1])] = " ".join(
                    x.strip().replace("ptxas info    : ", "")
                    for x in lines[i + 2:i + 4])
        lib = ctypes.CDLL(so)
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = _kernels.SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = (lib, regs)
    return libs


def main(trees=None, forms=FORMS, device="cuda", workload="asset"):
    """Build, check and time K2 of ``trees`` ({name: csrc dir}) and of this
    package's sources (``new``).  Returns {name: {form: [ms, ...]}}."""
    dev = timing.cuda_device(device)
    card = timing.card_line()
    trees = {**(trees or {}), "new": _kernels.CSRC_DIR}
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
        cases[f] = (form, args, comp.composite_backward_plain(*args))

    def launcher(lib, f):
        form, (table, gid, starts, counts, gx, packed, d_packed, _, _), _ = \
            cases[f]
        width = comp.ATTR_BASE + ((Cg + 1) // 2 if form.feat_packed else Cg)

        def run():
            d = torch.zeros((gid.shape[0], width), dtype=torch.float32,
                            device=dev)
            args = (table.data_ptr(), table.shape[0], C, Cg, gid.data_ptr(),
                    starts.data_ptr(), counts.data_ptr(), starts.shape[0],
                    gx, comp.TILE_X, comp.TILE_Y, packed.data_ptr(),
                    d_packed.data_ptr(), d.data_ptr(), _kernels.stream_of(d))
            err = (lib.gsplat_composite_backward(*args) if form == comp.F32
                   else lib.gsplat_composite_backward_form(form.bits, *args))
            if err != 0:
                raise RuntimeError(f"K2 {f}: CUDA error {err}")
            return d
        return run

    with tempfile.TemporaryDirectory() as tmp:
        libs = build(trees, tmp)
        for name, (lib, regs) in libs.items():
            print(f"k2_trees: {name} ({trees[name]}) C = 7: "
                  + "; ".join(f"form {b}: {r}" for b, r in sorted(
                      regs.items())))
            for f in forms:
                got = launcher(lib, f)()
                torch.cuda.synchronize()
                err, worst, bad = wl.compare_form_rows(
                    got, cases[f][2], Cg, cases[f][0].feat_packed)
                if bad:
                    raise RuntimeError(
                        f"K2 {f} of tree {name}: {bad} values outside the "
                        f"tolerance (worst column {worst:.3g})")
                print(f"k2_trees: {name} {f} within tolerance of the plain "
                      f"version (max |diff| {err:.3g}, worst column "
                      f"{worst:.2e} of its largest)")
        names = list(libs)
        ms = {n: {f: [] for f in forms} for n in names}
        for order in (names, names[::-1], names, names[::-1]):
            for n in order:
                for f in forms:
                    ms[n][f].append(timing.median_ms(
                        launcher(libs[n][0], f), 10))
    print(f"k2_trees: K2 on the {w.name} workload [{card}], median ms of "
          "10 launches, trees alternated (in order, reversed, twice)")
    for n in names:
        print(f"  {n:12s} " + "  ".join(
            f"{f} " + " ".join(f"{t:.4f}" for t in ms[n][f]) for f in forms))
    return ms


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    metavar="NAME=CSRC", help="another tree's csrc directory")
    ap.add_argument("--forms", default=",".join(FORMS))
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    main(trees, tuple(args.forms.split(",")))


if __name__ == "__main__":
    cli()
