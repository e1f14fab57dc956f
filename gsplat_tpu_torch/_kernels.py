"""Build, load and count the port's hand-written CUDA kernels.

Every source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface,
``_build/libgsplat_kernels.so``, at first use: each source is compiled to an
object by its own ``nvcc`` process, all started together, and one more
``nvcc`` links them, so the build takes as long as its largest source as
later slices add kernels.  The library is loaded with ``ctypes``; each C entry
launches on the stream it is given and returns ``cudaGetLastError()``, which
``check`` turns into an exception.

Nothing here runs at import: the CPU tests import every module, and the
machine that runs them has no ``nvcc`` and no card.

``launch_counts`` holds one plain integer per kernel.  A wrapper adds one
where it launches its kernel and nowhere else, so a caller can show that a
run really went through the kernels.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libgsplat_kernels.so")
SOURCES = ("common.cu", "expand.cu", "composite_fwd.cu", "composite_bwd.cu",
           "composite_fwd_forms.cu", "composite_bwd_forms.cu", "segsum.cu",
           "probe_fwd.cu", "probe_bwd.cu", "probe_load.cu", "probe_dtype.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
    # no fused multiply-add contraction: the kernels round every product and
    # sum like the plain PyTorch versions, which run one op at a time, so
    # K1's skip and termination decisions match its plain version exactly.
    # With contraction K1 ran about 5% faster on an H100 at the 1080p asset
    # and moved a few pixels by up to 2e-3 through flipped alpha >= 1/255
    # tests (chip_smoke.py times both builds; PERF.md).
    "--fmad=false",
    "-Xptxas", "-v",
)

# K1's and K2's forms (composite_cuda.Form.name) count apart
COMPOSITE_FORMS = ("", "_quad", "_packed", "_packed_quad")
launch_counts = {"expand": 0, "expand_extras": 0,
                 **{f"composite_{k}{f}": 0 for k in ("forward", "backward")
                    for f in COMPOSITE_FORMS},
                 "segment_sum": 0,
                 # the kernel probes of gsplat_tpu_torch/tools (P1 to P4)
                 "probe_forward": 0, "probe_backward": 0, "probe_load": 0,
                 "probe_dtype": 0}

_VP = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # offsets, meta, gid_src, S, I, rw_bits, grid_x, num_tiles,
    # tile_out, gid_out, stream
    "gsplat_expand": (_VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _VP, _VP),
    # offsets, meta, gid_src, extras, S, I, rw_bits, grid_x, num_tiles,
    # n_extra, tile_out, gid_out, extras_out, stream
    "gsplat_expand_extras": (_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _I,
                             _VP, _VP, _VP, _VP),
    # table, P, C, gauss_id, starts, counts, num_tiles, grid_x, tile_x,
    # tile_y, out, stream
    "gsplat_composite_forward": (_VP, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I,
                                 _VP, _VP),
    # table, P, C, Cg, gauss_id, starts, counts, num_tiles, grid_x, tile_x,
    # tile_y, packed, d_packed, d_inst, stream
    "gsplat_composite_backward": (_VP, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I,
                                  _I, _VP, _VP, _VP, _VP),
    # form (1 quad, 2 packed, 3 both), table, P, C, Cg, gauss_id, starts,
    # counts, num_tiles, grid_x, tile_x, tile_y, out, stream
    "gsplat_composite_forward_form": (_I, _VP, _I, _I, _I, _VP, _VP, _VP, _I,
                                      _I, _I, _I, _VP, _VP),
    # form, then gsplat_composite_backward's arguments
    "gsplat_composite_backward_form": (_I, _VP, _I, _I, _I, _VP, _VP, _VP,
                                       _I, _I, _I, _I, _VP, _VP, _VP, _VP),
    # C, Cg, tile_x, tile_y: CTAs per SM of the f32 form's kernel
    "gsplat_composite_backward_occupancy": (_I, _I, _I, _I),
    # C, tile_x, tile_y: CTAs per SM of K1's f32 form
    "gsplat_composite_forward_occupancy": (_I, _I, _I),
    # form, C, Cg, tile_x, tile_y: the same for another form of K1
    "gsplat_composite_forward_form_occupancy": (_I, _I, _I, _I, _I),
    # form, C, Cg, tile_x, tile_y: the same for another form
    "gsplat_composite_backward_form_occupancy": (_I, _I, _I, _I, _I),
    # vals, sids, perm (or null), I, R, num_segments, scratch, out, stream
    "gsplat_segment_sum": (_VP, _VP, _VP, _I, _I, _I, _VP, _VP, _VP),
    # num_segments: the int32 words of gsplat_segment_sum's scratch
    "gsplat_segment_sum_scratch": (_I,),
    # variant, then gsplat_composite_forward's arguments
    "gsplat_probe_forward": (_I, _VP, _I, _I, _VP, _VP, _VP, _I, _I, _I, _I,
                             _VP, _VP),
    # variant, then gsplat_composite_backward's arguments
    "gsplat_probe_backward": (_I, _VP, _I, _I, _I, _VP, _VP, _VP, _I, _I, _I,
                              _I, _VP, _VP, _VP, _VP),
    # variant, table, P, C, gauss_id, starts, counts, limits (or null),
    # num_tiles, grid_x, tile_x, tile_y, out, stream
    "gsplat_probe_load": (_I, _VP, _I, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _I,
                          _VP, _VP),
    # variant, src, P, R, ids (or null), I, out, stream
    "gsplat_probe_gather": (_I, _VP, _I, _I, _VP, _I, _VP, _VP),
    # variant, x, n, n_programs, n_iters, out, stream
    "gsplat_probe_dtype": (_I, _VP, _I, _I, _I, _VP, _VP),
    # tile_x, tile_y, out [npix + 1] int32 (zeroed), stream
    "gsplat_warp_map_check": (_I, _I, _VP, _VP),
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); the "
        "CUDA kernels of gsplat_tpu_torch cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    return any(os.path.getmtime(os.path.join(CSRC_DIR, f)) > built
               for f in os.listdir(CSRC_DIR))


def ptxas_entries(report: str, pattern) -> dict:
    """{match: (registers, spill store bytes)} of each kernel entry of a
    ``-Xptxas -v`` report whose mangled name ``pattern`` (a compiled regex)
    matches, keyed by the match's groups (its whole text without groups).
    An entry's lines run from its "Compiling entry" line to its "Used N
    registers" line."""
    out = {}
    key = None
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = pattern.search(line)
            key = (m.groups() if pattern.groups else m[0]) if m else None
            if key is not None:
                out[key] = [None, None]
            continue
        if key is None:
            continue
        regs = re.search(r"Used (\d+) registers", line)
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill:
            out[key][1] = int(spill[1])
        if regs:                        # the entry's last line
            out[key][0] = int(regs[1])
            key = None
    return {k: tuple(v) for k, v in out.items()}


def build() -> str:
    """Compile every source for sm_90a and link the shared library.
    Returns the ``-Xptxas -v`` report (registers, shared memory, spills per
    kernel)."""
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    objs, procs = [], []
    for src in SOURCES:
        obj = os.path.join(BUILD_DIR, src.replace(".cu", ".o"))
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c",
             os.path.join(CSRC_DIR, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    report = []
    failed = []
    for src, p in procs:
        out, _ = p.communicate()
        report.append(f"== {src}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + "\n"
                           + "\n".join(report))
    tmp = os.path.join(BUILD_DIR, f"libgsplat_kernels.{os.getpid()}.tmp.so")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-Xcompiler", "-fPIC", *objs, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed\n" + link.stdout)
    os.replace(tmp, LIB_PATH)
    return "\n".join(report)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if missing or older than a
    source."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            handle = ctypes.CDLL(LIB_PATH)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.gsplat_error_string.argtypes = (ctypes.c_int,)
            handle.gsplat_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, name: str):
    if err != 0:
        msg = lib().gsplat_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def require(cond: bool, msg: str):
    """Argument validation that survives ``python -O``."""
    if not cond:
        raise ValueError(msg)


def check_int32_vector(name: str, t: torch.Tensor, device: torch.device,
                       n=None):
    require(t.dtype == torch.int32, f"{name} must be int32, got {t.dtype}")
    require(t.dim() == 1, f"{name} must be 1-D, got shape {tuple(t.shape)}")
    require(t.is_contiguous(), f"{name} must be contiguous")
    require(t.device == device, f"{name} is on {t.device}, expected {device}")
    if n is not None:
        require(t.shape[0] == n, f"{name} has {t.shape[0]} rows, expected {n}")
