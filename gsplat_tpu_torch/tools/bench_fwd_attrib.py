"""Attribute the forward kernel K1's time on the card to its pieces.

Port of ``tools/bench_fwd_attrib.py``: P1 (``csrc/probe_fwd.cu``) with one
piece of K1 removed at a time (the early exit, the transmittance update,
the C-channel accumulation, the n_contrib bookkeeping; alpha alone) and
``quad_power``, the counterpart of the tool's ``mxu_alpha``.  Each
variant's median ms, its share of ``base`` (K1 itself) and its bound.

    python -m gsplat_tpu_torch.tools.bench_fwd_attrib [--workload synthetic]
"""
from gsplat_tpu_torch.tools import probes, timing
from gsplat_tpu_torch.tools import workload as wl

VARIANTS = ("base", "no_cond", "no_scan", "no_matmul", "no_minmax",
            "alpha_only", "quad_power")


def measure(w, variants, stats, iters=10):
    """Rows (name, ms, bound, launches) of P1's ``variants`` on ``w``."""
    return [timing.measure_row(
        v, lambda v=v: probes.probe_forward(v, *w.k1_args),
        wl.bound_ms(wl.k1_bytes(w), wl.fwd_ops(v, w.C, stats),
                    nexp=wl.fwd_exps(v, stats)),
        "probe_forward", iters) for v in variants]


def main(device="cuda", workload="asset", stats=None):
    """Time P1's attribution variants on the card."""
    dev = timing.cuda_device(device)
    card = timing.card_line()
    w = wl.load_workload(workload, dev)
    stats = stats or wl.pair_stats(w)
    return timing.report(f"bench_fwd_attrib: P1 on the {w.name} workload",
                         card, measure(w, VARIANTS, stats), "base")


if __name__ == "__main__":
    timing.cli(main)
