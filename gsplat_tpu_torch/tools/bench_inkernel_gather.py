"""Does a gather inside the kernel pay, on the card?

Port of ``tools/bench_inkernel_gather.py``: P3's ``row_gather`` reads each
slot's row by id from the ungathered [P, R] table inside the kernel (the
TPU's per-row indexed DMA), ``block_copy`` copies the pre-gathered [I, R]
table (the baseline), and ``index_select`` is PyTorch's gather of the same
rows (timed as the library call, used nowhere in the port).  At the TPU
tool's 128-float rows and at the production width 6 + C.  The asset
workload gathers the ids K1 reads (the sorted instance list's real
instances) from the asset's table and, at 128 floats, from a seeded random
table of the same P; the synthetic one is the tool's own (P = 500,000,
I = 2^19 ids from ``numpy.random.default_rng(0)``).

    python -m gsplat_tpu_torch.tools.bench_inkernel_gather [--workload synthetic]
"""
import numpy as np
import torch

from gsplat_tpu_torch.tools import probes, timing
from gsplat_tpu_torch.tools import workload as wl

R_TPU = 128            # the tool's row: one 128-lane tile


def tables(workload, dev):
    """[(label, table [P, R], ids [I] int32)] at 128 floats and at the
    production width."""
    if workload == "synthetic":
        rng = np.random.default_rng(0)
        P, I = 500_000, 1 << 19
        t128 = torch.from_numpy(rng.standard_normal((P, R_TPU)).astype(
            np.float32)).to(dev)
        ids = torch.from_numpy(rng.integers(0, P, I).astype(np.int32)).to(dev)
        return [("R=128", t128, ids),
                ("R=8", t128[:, :8].contiguous(), ids)]
    w = wl.load_workload(workload, dev)
    P = w.table.shape[0]
    ids = w.gauss_id[(w.gauss_id >= 0) & (w.gauss_id < P)]
    ids = ids[:ids.shape[0] // 1024 * 1024 or ids.shape[0]].contiguous()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t128 = torch.randn((P, R_TPU), generator=gen, device=dev)
    return [("R=128", t128, ids), (f"R={w.table.shape[1]}", w.table, ids)]


def measure(cases, iters=10):
    """Per case: rows of row_gather, block_copy and index_select, with
    their bounds; ``note`` gives ns per row."""
    out = []
    for label, table, ids in cases:
        I, R = ids.shape[0], table.shape[1]
        pre = probes.probe_gather("row_gather", table, ids)
        idx = ids.long()
        unique = int(torch.unique(ids).numel())
        fns = {"row_gather": lambda: probes.probe_gather("row_gather", table,
                                                         ids),
               "block_copy": lambda: probes.probe_gather("block_copy", pre),
               "index_select": lambda: torch.index_select(table, 0, idx)}
        rows = []
        for name, fn in fns.items():
            row = timing.measure_row(
                name, fn, wl.gather_bound(
                    "block_copy" if name == "block_copy" else "row_gather",
                    I, R, unique),
                None if name == "index_select" else "probe_load", iters)
            row["note"] = f"{row['ms'] * 1e6 / I:.3f} ns/row"
            rows.append(row)
        out.append((label, I, rows))
    return out


def main(device="cuda", workload="asset"):
    """Time the in-kernel gather against a block copy and index_select."""
    dev = timing.cuda_device(device)
    card = timing.card_line()
    result = []
    for label, I, rows in measure(tables(workload, dev)):
        result.append((label, timing.report(
            f"bench_inkernel_gather: {I} rows, {label}", card, rows,
            "block_copy")))
    return result


if __name__ == "__main__":
    timing.cli(main)
