"""Attribute the backward kernel K2's time on the card to its pieces.

Port of ``tools/bench_bwd_attrib.py``: P2 (``csrc/probe_bwd.cu``) with the
moments taken over the pixel basis, the Gaussian through ``exp`` instead of
``exp2``, and the alpha recompute, the moment sums or the feature sums
removed.  Each variant's median ms, its share of ``base`` (K2 itself) and
its bound.

    python -m gsplat_tpu_torch.tools.bench_bwd_attrib [--workload synthetic]
"""
from gsplat_tpu_torch.tools import probes, timing
from gsplat_tpu_torch.tools import workload as wl

VARIANTS = probes.BWD_VARIANTS


def measure(w, variants, stats, iters=10):
    """Rows (name, ms, bound, launches) of P2's ``variants`` on ``w``."""
    return [timing.measure_row(
        v, lambda v=v: probes.probe_backward(v, *w.k2_args),
        wl.bound_ms(wl.k2_bytes(w), wl.bwd_ops(v, w.C, w.Cg, stats)),
        "probe_backward", iters) for v in variants]


def main(device="cuda", workload="asset", stats=None):
    """Time P2's attribution variants on the card."""
    dev = timing.cuda_device(device)
    card = timing.card_line()
    w = wl.load_workload(workload, dev)
    stats = stats or wl.pair_stats(w)
    return timing.report(f"bench_bwd_attrib: P2 on the {w.name} workload",
                         card, measure(w, VARIANTS, stats), "base")


if __name__ == "__main__":
    timing.cli(main)
