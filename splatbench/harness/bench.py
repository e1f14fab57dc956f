"""One run of one cell: the module of its traffic's kind
(``splatbench/harness/<kind>.py``) sets up, runs the window (timed, or
traced with ``trace``), reads the device's peak memory, frees the program
and hands what the timed path produced to the reference; this module turns
that into the result line."""
from __future__ import annotations

import gc
import importlib
import sys

import torch

from splatbench.harness import check
from splatbench.reference import splat

FORBIDDEN = ("jax", "jaxlib", "flax", "gsplat_tpu")


class Ctx:
    """What a kind's ``run`` is given: the cell, the run's arguments and the
    device's bookkeeping."""

    def __init__(self, cell, seed, seconds, trace, device, t_start,
                 budget=splat.BUDGET):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.t_start, self.budget = bool(trace), t_start, budget
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return (int(torch.cuda.max_memory_allocated(self.device))
                if self.cuda else 0)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell, seed, seconds, trace, device, t_start,
             budget=splat.BUDGET) -> dict:
    # the mix's kind names its module, splatbench/harness/<kind>.py
    kind = importlib.import_module("splatbench.harness."
                                     + cell.traffic["kind"])
    ctx = Ctx(cell, seed, seconds, trace, device, t_start, budget)
    res = kind.run(ctx)
    ok, checks = check.judge(res["numbers"], cell.limits)
    out = {"correct": bool(ok and res["failed"] == 0),
           "attempted": res["attempted"], "failed": res["failed"]}
    dev = {"platform": "gpu" if ctx.cuda else ctx.device.type,
           "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": res["peak"]}
    if trace:
        rec = res["records"]
        metrics = {}
        for entry, read in cell.per_layer:
            v = read(rec)
            if v is not None:
                metrics[entry["name"]] = {"value": v, "unit": entry["unit"]}
        dev.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        out.update(metrics=metrics, device=dev, breakdown=rec["breakdown"])
    else:
        # a metric "<quantity>.<variant>" reports the kind's <quantity>,
        # under a bound of its own
        out.update(metrics={m["name"]: {
            "value": res["e2e"][m["name"].split(".")[0]], "unit": m["unit"]}
            for m in cell.end_to_end}, device=dev)
    out["checks"] = checks
    return out
