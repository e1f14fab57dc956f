"""Does 16-bit elementwise math run faster than 32-bit on the card?

Port of ``tools/bench_vpu_dtype.py``: P4 (``csrc/probe_dtype.cu``) runs the
tool's alpha-shaped mix (mul, add, exp) 64 times over a [256, 1024] block
in each of 64 programs, in float32 and in packed bfloat16 pairs.  Each
form's median ms, its share of float32, its bound and its element rate.
The block is the tool's (x = 0.3 everywhere) for either workload.

    python -m gsplat_tpu_torch.tools.bench_vpu_dtype
"""
import torch

from gsplat_tpu_torch.tools import probes, timing
from gsplat_tpu_torch.tools import workload as wl

SHAPE = (256, 1024)
N_PROGRAMS = 64
N_ITERS = 64


def inputs(dev):
    return {"f32": torch.full(SHAPE, 0.3, device=dev),
            "bf16": torch.full(SHAPE, 0.3, device=dev,
                               dtype=torch.bfloat16)}


def measure(xs, iters=10):
    """Rows (name, ms, bound, launches, note: element rate) of P4."""
    rows = []
    for name, x in xs.items():
        row = timing.measure_row(
            name, lambda x=x: probes.probe_dtype(x, N_PROGRAMS, N_ITERS),
            wl.dtype_bound(x.numel(), x.element_size(), N_PROGRAMS, N_ITERS,
                           name == "bf16"), "probe_dtype", iters)
        elems = x.numel() * N_PROGRAMS * N_ITERS
        row["note"] = f"{elems / row['ms'] / 1e9:.3f} Telem/s"
        rows.append(row)
    return rows


def main(device="cuda", workload="asset"):
    """Time the op mix in float32 and in packed bfloat16."""
    del workload                       # the tool's block either way
    dev = timing.cuda_device(device)
    card = timing.card_line()
    rows = timing.report("bench_vpu_dtype: P4", card,
                         measure(inputs(dev)), "f32")
    print(f"  bf16 speedup over f32: {rows[0]['ms'] / rows[1]['ms']:.3f}x")
    return rows


if __name__ == "__main__":
    timing.cli(main)
