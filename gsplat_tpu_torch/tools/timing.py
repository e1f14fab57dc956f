"""Timing on the card for the probes: CUDA events around each launch, and
the card's name and power limit to stand beside every number."""
from __future__ import annotations

import statistics
import subprocess

import torch

from gsplat_tpu_torch import _kernels
from gsplat_tpu_torch.device import resolve_device


def cuda_device(device="cuda") -> torch.device:
    """The card a measurement runs on.  A measurement never falls back to
    the CPU: anything but a usable CUDA device raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(
            f"gsplat_tpu_torch.tools: timing needs a CUDA device, got {dev}; "
            "the plain versions are checked on the CPU by the tests")
    return dev


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, as
    ``name, power.limit`` (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


# Device cycles (about 10 ms on an H100) the card sleeps before the timed
# calls, so that the host has enqueued them all before the first one runs.
SPACER_CYCLES = 20_000_000


def median_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median ms of ``iters`` warmed calls of ``fn``, each between its own
    pair of CUDA events on the current stream.  The card is kept busy
    (``torch.cuda._sleep``) while the host enqueues the calls, so the
    events bracket the device's work only: without it, a kernel shorter
    than the wrapper's host time (tens of microseconds) is timed with the
    idle gap before its launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPACER_CYCLES)
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def event_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` over ``iters`` back-to-back calls between
    one pair of CUDA events.  The card waits on the host between calls
    whenever enqueueing a call takes longer than running it, so for a short
    kernel this times its wrapper's host work; ``median_ms`` times the
    device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def measure_row(name: str, fn, bound, counter=None, iters: int = 10,
                **extra) -> dict:
    """One result row: ``fn``'s median ms, its ``bound`` (ms, "bytes" or
    "operations") and, with ``counter`` (a key of ``_kernels.
    launch_counts``), how many launches the timing made."""
    before = _kernels.launch_counts[counter] if counter else 0
    ms = median_ms(fn, iters)
    row = dict(name=name, ms=ms, bound_ms=bound[0], bound_by=bound[1],
               **extra)
    if counter:
        row["launches"] = _kernels.launch_counts[counter] - before
    return row


def report(title: str, card: str, rows, base: str):
    """Print one line per row (name, ms, share of ``base``'s ms, bound) under
    ``title`` and the card line; adds ``share`` to each row and returns the
    rows."""
    base_ms = next(r["ms"] for r in rows if r["name"] == base)
    print(f"{title} [{card}]")
    for r in rows:
        r["share"] = r["ms"] / base_ms
        print(f"  {r['name']:<22s} {r['ms']:9.4f} ms  {r['share']:7.3f} of "
              f"{base}  bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              + (f"  launches {r['launches']}" if "launches" in r else "")
              + (f"  {r['note']}" if r.get("note") else ""))
    return rows


def cli(main, argv=None):
    """``python -m gsplat_tpu_torch.tools.<name> [--workload asset|synthetic]
    [--device cuda:N]``."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--workload", default="asset",
                    choices=("asset", "synthetic"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    main(device=args.device, workload=args.workload)
