"""Loads against compute in the forward kernel K1, on the card.

Port of ``tools/bench_dma_overhead.py``: K1 itself (``full``), P3's
``load_only`` (K1's staging on K1's CTAs, each CTA of a tile staging
exactly the batches it stages in K1, one add per batch),
``compute_resident`` (K1's math on each tile's first batch, staged once)
and ``load_only_4tiles`` (the staging with each CTA walking its part of 4
tiles).
Each variant's median ms, its share of ``full`` and its bound: if K1 takes
about as long as ``compute_resident`` and far longer than ``load_only``, it
waits on its math, not its loads.

    python -m gsplat_tpu_torch.tools.bench_dma_overhead [--workload synthetic]
"""
from gsplat_tpu_torch.ops import composite_cuda as comp
from gsplat_tpu_torch.tools import probes, timing
from gsplat_tpu_torch.tools import workload as wl
from gsplat_tpu_torch.tools.workload import k1_culled_pairs, resident_ids

VARIANTS = ("full",) + probes.LOAD_VARIANTS


def measure(w, stats, iters=10):
    """Rows (name, ms, bound, launches) of K1 and P3's tile variants."""
    limits = stats["limits"]
    res = probes.probe_load("compute_resident", *w.k1_args)
    res_pairs = k1_culled_pairs(w.table, resident_ids(
        w.gauss_id, w.starts, w.counts), w.starts, w.counts, w.grid_x,
        res[:, w.C + 1])
    bounds = wl.load_bounds(w, limits, res_pairs)
    bounds["full"] = wl.bound_ms(wl.k1_bytes(w), wl.fwd_ops("base", w.C,
                                                            stats))
    fns = {"full": lambda: comp.composite_forward(*w.k1_args),
           "compute_resident": lambda: probes.probe_load(
               "compute_resident", *w.k1_args)}
    for v in ("load_only", "load_only_4tiles"):
        fns[v] = lambda v=v: probes.probe_load(v, *w.k1_args, limits=limits)
    return [timing.measure_row(
        v, fns[v], bounds[v],
        "composite_forward" if v == "full" else "probe_load", iters)
        for v in VARIANTS]


def main(device="cuda", workload="asset", stats=None):
    """Time K1 against its loads and its math on the card."""
    dev = timing.cuda_device(device)
    card = timing.card_line()
    w = wl.load_workload(workload, dev)
    stats = stats or wl.pair_stats(w)
    limits = stats["limits"].long()
    print(f"bench_dma_overhead: K1's CTAs stage {int(limits.sum())} instance "
          f"rows, {int(limits.amax(dim=1).sum())} of the "
          f"{int(w.counts.sum())} instances once a tile, before their early "
          "exits")
    return timing.report(f"bench_dma_overhead: K1 and P3 on the {w.name} "
                         "workload", card, measure(w, stats), "full")


if __name__ == "__main__":
    timing.cli(main)
