"""A/B of K1 and K2 layout variants on the card, on real inputs.

Port of ``tools/bench_kernels.py``: the forward with the quadratic-form
power (``quad_power``, the tool's variant A), trimmed bookkeeping (R), no
termination (``stripped``, S) and exp as identity (``no_exp``, N); the
backward with the pixel-moment basis (``moments_basis``, B).  Each
variant's median ms, its share of ``base`` and its bound, and, as the tool
prints them (:503, :541-545), the max |diff| of ``quad_power`` against
``base`` and of ``moments_basis`` against ``base`` over the largest |base|.
The tool read inputs dumped to /tmp; here they are the asset's own.

    python -m gsplat_tpu_torch.tools.bench_kernels [--workload synthetic]
"""
import torch

from gsplat_tpu_torch.tools import bench_bwd_attrib, bench_fwd_attrib
from gsplat_tpu_torch.tools import probes, timing
from gsplat_tpu_torch.tools import workload as wl

FWD = ("base", "quad_power", "trim_bookkeeping", "stripped", "no_exp")
BWD = ("base", "moments_basis")


def diffs(w):
    """(max |diff| of quad_power against base over the channels and
    T_final, pixels whose n_contrib differs, max |diff| of moments_basis
    against base over max |base|)."""
    C = w.C
    f0 = probes.probe_forward("base", *w.k1_args)
    fa = probes.probe_forward("quad_power", *w.k1_args)
    d0 = probes.probe_backward("base", *w.k2_args)
    db = probes.probe_backward("moments_basis", *w.k2_args)
    return (float((f0[:, :C + 1] - fa[:, :C + 1]).abs().max()),
            int((f0[:, C + 1] != fa[:, C + 1]).sum()),
            float((d0 - db).abs().max() / torch.clamp(d0.abs().max(),
                                                       min=1e-30)))


def main(device="cuda", workload="asset", stats=None):
    """Time the K1/K2 layout variants on the card."""
    dev = timing.cuda_device(device)
    card = timing.card_line()
    w = wl.load_workload(workload, dev)
    stats = stats or wl.pair_stats(w)
    fwd = timing.report(f"bench_kernels: P1 on the {w.name} workload", card,
                        bench_fwd_attrib.measure(w, FWD, stats), "base")
    bwd = timing.report(f"bench_kernels: P2 on the {w.name} workload", card,
                        bench_bwd_attrib.measure(w, BWD, stats), "base")
    err_a, nc_a, err_b = diffs(w)
    print(f"  quad_power vs base: max |diff| {err_a:.3e} (channels and "
          f"T_final), n_contrib differs at {nc_a} pixels; moments_basis vs "
          f"base: max |diff| / max |base| {err_b:.3e}")
    return fwd, bwd, (err_a, nc_a, err_b)


if __name__ == "__main__":
    timing.cli(main)
