"""The port's own spans and counters (``gsplat_tpu_torch/tracing.py``) in a
training cell, read from two windows (``record``, meant to follow the cell's
traced one):

- a host-traced profiler window with the port's tracing on, in which every
  device operation is put down to the innermost port span that launched it,
  and every idle gap to the innermost port span running at its middle;
- one more chunk with the port's spans on and the profiler off, whose span
  records give each span's self time on the host clock, and whose counter
  deltas give the readbacks.

    python3 -m splatbench.harness.port_spans --workload <cell> --seed <n> \\
        [--dump <file>]

runs the cell's set-up as ``harness/train.py`` does, then these two
windows, and prints one JSON line: the port's records (``port``) and the
eight numbers ``numbers`` reads from them.  ``--dump`` writes the
host-traced window's events, as ``event_rows`` makes them, to a gzipped
JSON file.

Against a port without ``tracing`` the record is None."""
from __future__ import annotations

import argparse
import bisect
import collections
import gzip
import json
import os
import sys
import time

PREFIX = "gsplat."
# the five layers of the step, each the spans whose device time it reads
LAYERS = {"preprocess_ms": ("rasterize.preprocess",),
          "binning_ms": ("rasterize.binning",),
          "composite_ms": ("rasterize.composite", "composite.backward"),
          "losses_ms": ("step.losses",),
          "update_ms": ("step.update",)}
NUMBERS = (*LAYERS, "dispatch_ms", "sync_wait_ms", "host_syncs")
# one profiler event: name, on the device or not, start and end (ns), the
# host thread, its correlation id and the one of the host operation it is
# linked to, its autograd sequence number and forward thread
NAME, DEV, START, END, THREAD, CORR, LINKED, SEQ, FWD = range(9)


def port_tracing():
    """The port's tracing module, or None where the port has none."""
    try:
        from gsplat_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def event_rows(events) -> list:
    """The profiler's events as tuples (``NAME`` ... ``FWD``)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in events:
        dev = e.device_type() == cuda
        if dev and (e.is_user_annotation() or e.name().startswith(PREFIX)):
            continue    # a record_function range mirrored on the device
        s = e.start_ns()
        out.append((e.name(), dev, s, s + e.duration_ns(),
                    e.start_thread_id(), e.correlation_id(),
                    e.linked_correlation_id(), e.sequence_nr(),
                    e.fwd_thread_id()))
    return out


class Timeline:
    """The innermost of nested intervals ``(start, end, value)`` at any
    time (None outside them all)."""

    def __init__(self, intervals):
        self.times, self.owner = [], []
        stack = []

        def close(upto):
            while stack and stack[-1][0] <= upto:
                end = stack.pop()[0]
                self.times.append(end)
                self.owner.append(stack[-1][1] if stack else None)

        for s, e, v in sorted(intervals, key=lambda x: (x[0], -x[1])):
            close(s)
            stack.append((e, v))
            self.times.append(s)
            self.owner.append(v)
        close(float("inf"))

    def at(self, t):
        i = bisect.bisect_right(self.times, t) - 1
        return self.owner[i] if i >= 0 else None


def attribute(rows, units: int) -> dict:
    """Each port span's self device ms a unit, the ms no rule attributes
    (``unattributed_ms``), the device operations' ms and busy ms a unit,
    the ms each rule attributed, and the idle gaps named by port span.

    A device operation belongs to the innermost port span around its
    launch: the host call with its correlation id, else the host operation
    it is linked to.  A launch outside every port span of its thread (the
    autograd engine's) belongs to the span that ran the forward operation
    of the backward node around it (same sequence number, on the node's
    forward thread); failing that, to the innermost port span of the thread
    that holds the ``iter`` spans at the launch."""
    host = [r for r in rows if not r[DEV] and r[END] > r[START]]
    dev = [r for r in rows if r[DEV]]
    threads = collections.defaultdict(list)
    for r in host:
        threads[r[THREAD]].append(r)
    spans, nodes = {}, {}
    for t, rs in threads.items():
        spans[t] = Timeline([(r[START], r[END], (r[NAME][len(PREFIX):],
                                                 r[START]))
                             for r in rs if r[NAME].startswith(PREFIX)])
        nodes[t] = Timeline([(r[START], r[END], (r[FWD], r[SEQ]))
                             for r in rs if r[FWD] > 0 and r[SEQ] >= 0])
    main = max(threads, default=None, key=lambda t: sum(
        r[NAME] == PREFIX + "iter" for r in threads[t]))
    # (thread, sequence number) -> the start of the last operation that
    # carried it: every operation under autograd carries the number the
    # next node will take, so the last one made the node
    forward = {}
    for r in host:
        if r[SEQ] >= 0 and r[FWD] <= 0:
            k = (r[THREAD], r[SEQ])
            forward[k] = max(forward.get(k, r[START]), r[START])
    # the runtime's calls share their device operation's correlation id;
    # the framework's operations have ids of their own
    calls = {r[CORR]: r for r in host if r[NAME].startswith("cu")}
    ops = {r[CORR]: r for r in host
           if r[CORR] > 0 and not r[NAME].startswith("cu")}

    def owner(d):
        launch = calls.get(d[CORR]) or ops.get(d[LINKED])
        if launch is None:
            return None, "no_launch"
        t, at = launch[THREAD], launch[START]
        s = spans[t].at(at)
        if s is not None:
            return s[0], "span"
        node = nodes[t].at(at)
        if node is not None:
            t0 = forward.get(node)
            s = spans[node[0]].at(t0) if t0 is not None and \
                node[0] in spans else None
            if s is not None:
                return s[0], "sequence"
        s = spans[main].at(at) if main in spans else None
        return (s[0], "main_thread") if s else (None, "outside")

    seconds = collections.Counter()
    rules = collections.Counter()
    for d in dev:
        name, rule = owner(d)
        seconds[name] += d[END] - d[START]
        rules[rule] += d[END] - d[START]

    def ms(ns):
        return ns / units / 1e6

    busy, end, gaps = 0, None, collections.Counter()
    for d in sorted(dev, key=lambda r: r[START]):
        if end is None or d[START] > end:
            if end is not None:
                gaps[_innermost(spans, (d[START] + end) / 2)] += \
                    (d[START] - end) / 1e9
            busy += d[END] - d[START]
            end = d[END]
        elif d[END] > end:
            busy += d[END] - end
            end = d[END]
    unattributed = seconds.pop(None, 0)
    return dict(
        device_ms={k: ms(v) for k, v in sorted(seconds.items())},
        unattributed_ms=ms(unattributed),
        device_op_ms=ms(sum(d[END] - d[START] for d in dev)),
        busy_ms=ms(busy), rules_ms={k: ms(v) for k, v in rules.items()},
        idle_gaps=[[k, v] for k, v in gaps.most_common(10)])


def _innermost(spans: dict, t) -> str:
    """The name of the latest-starting port span, on any thread, that runs
    at ``t``."""
    best = None
    for tl in spans.values():
        s = tl.at(t)
        if s is not None and (best is None or s[1] > best[1]):
            best = s
    return best[0] if best else "outside any port span"


def self_ns(spans: list) -> list:
    """Each span record's duration less its children's (its self time)."""
    out = [s["end"] - s["start"] for s in spans]
    for s in spans:
        if s["parent"] is not None:
            out[s["parent"]] -= s["end"] - s["start"]
    return out


def host_times(took: dict, before: dict, units: int) -> dict:
    """Each span's self ms on the host clock a unit, and each counter's
    change a unit, from ``tracing.take()`` after a window and the counters
    before it."""
    spans = took["spans"]
    self_ms = collections.Counter()
    total = collections.Counter()
    for s, own in zip(spans, self_ns(spans)):
        self_ms[s["name"]] += own / units / 1e6
        total[s["name"]] += (s["end"] - s["start"]) / units / 1e6
    counters = {k: (v - before.get(k, 0)) / units
                for k, v in took["counters"].items() if v != before.get(k, 0)}
    return dict(host_self_ms=dict(self_ms), host_ms=dict(total),
                counters=counters)


def record(ctx, chunks, units: int):
    """The two windows (the module's docstring) after the cell's traced
    one, ``chunks(1)`` running ``units`` steps; None without the port's
    tracing."""
    from splatbench.harness.trace import profiled
    tracing = port_tracing()
    if tracing is None:
        return None
    was = tracing.on()
    try:
        _, events, _ = profiled(lambda: chunks(1), lambda: chunks(1), ctx,
                                host=True)
        tracing.take()
        before = tracing.counters()
        chunks(1)
        ctx.sync()
        took = tracing.take()
    finally:
        tracing.on(was)
    rows = event_rows(events)
    port = attribute(rows, units)
    port.update(host_times(took, before, units))
    return port, rows


def numbers(port) -> dict:
    """The eight numbers of a cell's port record; a device number is left
    out where the window held no device operation."""
    if not port:
        return {}
    out = {}
    if port["device_op_ms"] > 0:
        for k, names in LAYERS.items():
            out[k] = sum(port["device_ms"].get(n, 0.0) for n in names)
    host = port["host_ms"]
    if "iter" in host:
        out["sync_wait_ms"] = host.get("sync", 0.0)
        out["dispatch_ms"] = host["iter"] - out["sync_wait_ms"]
        out["host_syncs"] = port["counters"].get("host_syncs", 0.0)
    return out


def run(cell, seed: int, device: str, budget=None):
    """The cell's set-up (``harness/train.py``'s ``prepare``, ``start`` and
    warm chunks), then ``record``'s windows: the result and the host-traced
    window's event rows."""
    from splatbench.harness import bench, train
    ctx = bench.Ctx(cell, seed, 0, True, device, time.perf_counter(),
                    **({"budget": budget} if budget else {}))
    r = train.start(ctx, train.prepare(ctx), seed)
    r["chunks"](cell.traffic["warm_chunks"])
    ctx.sync()
    res, rows = dict(cell=cell.name, seed=seed), []
    got = record(ctx, r["chunks"], cell.traffic["chunk"])
    if got is not None:
        res["port"], rows = got
        res["numbers"] = numbers(res["port"])
    if ctx.cuda:
        import torch
        res["card"] = torch.cuda.get_device_name(ctx.device)
    return res, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--dump", default="")
    args = ap.parse_args(argv)
    out, sys.stdout = sys.stdout, sys.stderr
    from splatbench.harness import spec
    cell = spec.load(args.workload)
    # the port reads its tile shape once, when it is imported
    os.environ["GSPLAT_TILE_X"] = os.environ["GSPLAT_TILE_Y"] = str(
        cell.config["tile"])
    res, rows = run(cell, args.seed, "cuda")
    if args.dump:
        with gzip.open(args.dump, "wt") as f:
            json.dump(rows, f)
    print(json.dumps(res), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
