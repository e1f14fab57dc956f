"""Compare the SASS nvcc emits for K1's and K2's f32 forms, K3x and P4,
between two trees of ``gsplat_tpu_torch/csrc``, or count one opcode in a
tree's kernels.

    python -m gsplat_tpu_torch.tools.sass_diff --old <csrc dir> [--new <dir>] \
        [--kernels forward|backward|expand|dtype|all]
    python -m gsplat_tpu_torch.tools.sass_diff --count MUFU.EX2 \
        --kernels dtype [--new <dir>]

compiles ``composite_fwd.cu``, ``composite_bwd.cu`` and ``expand.cu`` of
both trees with
the build's flags (``_kernels.NVCC_FLAGS``) to cubins, disassembles them
with ``cuobjdump -sass`` and compares each kernel instruction for
instruction.  A kernel is named by its template arguments: a form argument
0 (``composite_forward_kernel<CT, V, 0>``) is the same kernel as the one
without it (``<CT, V>``), so is a row-crossing argument false (K1's
``<CT, V, F, false>``), and the anonymous namespace's per-file tag is
dropped.  Prints one line per kernel and exits 1 if any differs or is
missing from either tree; ``--kernels`` compares K1's (forward), K2's
(backward), K3x (expand: ``expand_extras_kernel``; K3 is not compared)
or P4's two forms (dtype) alone.  ``--count`` prints, for each kernel of
the ``--new`` tree, the instructions whose opcode starts with the given
one (P4's bf16 form against its f32 form: the exponentials a pair takes).
Needs ``nvcc`` and ``cuobjdump``, no card.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

from gsplat_tpu_torch import _kernels

SOURCES = {"forward": "composite_fwd.cu", "backward": "composite_bwd.cu",
           "expand": "expand.cu", "dtype": "probe_dtype.cu"}
_KERNEL = re.compile(r"(composite_(?:forward|backward)_kernel)"
                     r"ILi(-?\d+)ELi(-?\d+)E(?:Li(-?\d+)E)?(?:Lb(\d)E)?E"
                     r"|(expand_extras_kernel|probe_dtype_(?:f32|bf16))")


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(_kernels.find_nvcc()), name)


def kernels(csrc: str, out_dir: str, which=tuple(SOURCES)) -> dict:
    """{(kernel, CT, V, form, cross): [SASS lines]} of the sources in
    ``csrc`` (``which``: keys of SOURCES)."""
    flags = [f for f in _kernels.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    found = {}
    for src in (SOURCES[k] for k in which):
        cubin = os.path.join(out_dir, src.replace(".cu", ".cubin"))
        subprocess.run([_kernels.find_nvcc(), *flags, "-I", csrc, "-cubin",
                        os.path.join(csrc, src), "-o", cubin], check=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin],
                              check=True, capture_output=True,
                              text=True).stdout
        name, lines = None, []
        for line in sass.splitlines():
            if "Function :" in line:
                if name is not None:
                    found[name] = lines
                m = _KERNEL.search(line)
                name = (None if m is None else
                        (m[6], 0, 0, 0, 0) if m[6] else
                        (m[1], int(m[2]), int(m[3]), int(m[4] or 0),
                         int(m[5] or 0)))
                lines = []
            elif name is not None and line.strip().startswith("/*"):
                # cuobjdump pads the columns to the widest instruction of
                # the file, which another kernel of it may set
                lines.append(" ".join(line.split()))
        if name is not None:
            found[name] = lines
    return found


def opcode(line: str) -> str:
    """The opcode of a SASS line as ``kernels`` keeps it ("/*0090*/ @P0
    MUFU.EX2 R5, R4 ;..."), past its predicate; an encoding line gives its
    hex word."""
    toks = line.split()
    return toks[2] if toks[1].startswith("@") else toks[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="the parent's csrc")
    ap.add_argument("--new", default=_kernels.CSRC_DIR)
    ap.add_argument("--kernels", default="all",
                    choices=(*SOURCES, "all"))
    ap.add_argument("--count", metavar="OPCODE",
                    help="count OPCODE in the --new tree's kernels")
    args = ap.parse_args(argv)
    which = tuple(SOURCES) if args.kernels == "all" else (args.kernels,)
    if args.count:
        with tempfile.TemporaryDirectory() as b:
            for key, lines in sorted(kernels(args.new, b, which).items(),
                                     key=str):
                n = sum(opcode(line).startswith(args.count)
                        for line in lines)
                print(f"{key[0]}: {n} {args.count}, {len(lines)} "
                      "instructions")
        return 0
    if not args.old:
        ap.error("--old is needed unless --count is given")
    with tempfile.TemporaryDirectory() as a, \
            tempfile.TemporaryDirectory() as b:
        old, new = kernels(args.old, a, which), kernels(args.new, b, which)
    same = True
    for key in sorted(set(old) | set(new), key=str):
        o, n = old.get(key), new.get(key)
        if o is None or n is None:
            status = "only in " + ("new" if o is None else "old")
        elif o == n:
            status = f"identical, {len(o)} instructions"
        else:
            diff = sum(x != y for x, y in zip(o, n)) + abs(len(o) - len(n))
            status = f"DIFFERS: {len(o)} -> {len(n)} instructions, {diff} " \
                     "lines differ"
        same &= status.startswith("identical")
        args = (f"<CT={key[1]}, V={key[2]}, form={key[3]}"
                f"{', cross' if key[4] else ''}>"
                if key[0].startswith("composite") else "")
        print(f"{key[0]}{args}: {status}")
    print(f"sass_diff: {len(old)} kernels in the old tree, {len(new)} in the "
          f"new; {'all identical' if same else 'NOT identical'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
