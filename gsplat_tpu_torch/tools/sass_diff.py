"""Compare the SASS nvcc emits for K1's and K2's f32 forms between two
trees of ``gsplat_tpu_torch/csrc``.

    python -m gsplat_tpu_torch.tools.sass_diff --old <csrc dir> [--new <dir>] \
        [--kernels forward|backward|all]

compiles ``composite_fwd.cu`` and ``composite_bwd.cu`` of both trees with
the build's flags (``_kernels.NVCC_FLAGS``) to cubins, disassembles them
with ``cuobjdump -sass`` and compares each kernel instruction for
instruction.  A kernel is named by its template arguments: a form argument
0 (``composite_forward_kernel<CT, V, 0>``) is the same kernel as the one
without it (``<CT, V>``), so is a row-crossing argument false (K1's
``<CT, V, F, false>``), and the anonymous namespace's per-file tag is
dropped.  Prints one line per kernel and exits 1 if any differs or is
missing from either tree; ``--kernels`` compares K1's (forward) or K2's
(backward) alone.  Needs ``nvcc`` and ``cuobjdump``, no card.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile

from gsplat_tpu_torch import _kernels

SOURCES = {"forward": "composite_fwd.cu", "backward": "composite_bwd.cu"}
_KERNEL = re.compile(r"(composite_(?:forward|backward)_kernel)"
                     r"ILi(-?\d+)ELi(-?\d+)E(?:Li(-?\d+)E)?(?:Lb(\d)E)?E")


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(_kernels.find_nvcc()), name)


def kernels(csrc: str, out_dir: str, which=tuple(SOURCES)) -> dict:
    """{(kernel, CT, V, form, cross): [SASS lines]} of the f32 sources in
    ``csrc`` (``which``: "forward", "backward")."""
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
                        (m[1], int(m[2]), int(m[3]), int(m[4] or 0),
                         int(m[5] or 0)))
                lines = []
            elif name is not None and line.strip().startswith("/*"):
                lines.append(line.strip())
        if name is not None:
            found[name] = lines
    return found


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True, help="the parent's csrc")
    ap.add_argument("--new", default=_kernels.CSRC_DIR)
    ap.add_argument("--kernels", default="all",
                    choices=("forward", "backward", "all"))
    args = ap.parse_args(argv)
    which = tuple(SOURCES) if args.kernels == "all" else (args.kernels,)
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
        print(f"{key[0]}<CT={key[1]}, V={key[2]}, form={key[3]}"
              f"{', cross' if key[4] else ''}>: {status}")
    print(f"sass_diff: {len(old)} kernels in the old tree, {len(new)} in the "
          f"new; {'all identical' if same else 'NOT identical'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
