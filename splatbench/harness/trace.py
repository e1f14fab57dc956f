"""The traced window: ``torch.profiler`` over a fixed amount of the cell's
work, reduced to what the per-layer readers take: the device's busy time
(the union of its operations' intervals), the operations counted and timed
by name, the idle gaps named by the host operation that ran during each,
and the harness's own spans around calls into the port."""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

SPAN_PREFIX = "splatbench."


class Spans:
    """Host-clock spans the harness opens around calls into the port; each
    is also a ``record_function`` range, so the trace's idle gaps can name
    it."""

    def __init__(self, sync):
        self.sync = sync
        self.seconds = collections.defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        with torch.profiler.record_function(SPAN_PREFIX + name):
            t0 = time.perf_counter()
            yield
            if sync:
                self.sync()
            self.seconds[name].append(time.perf_counter() - t0)


def profiled(warm, fn, ctx, host: bool):
    """Run ``warm()`` with the profiler warming up (its records dropped),
    then ``fn()`` recorded: the card's device when ``ctx`` runs on one, and
    the host's operations with ``host`` (which slows the host several fold,
    so the metrics' window records the device alone and a second,
    host-traced window names the idle gaps).  Returns (``fn``'s result, the
    recorded window's events, its seconds on the host clock from the call
    to the device's last operation)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = (([ProfilerActivity.CPU] if host or not ctx.cuda else [])
            + ([ProfilerActivity.CUDA] if ctx.cuda else []))
    got = []
    with profile(activities=acts,
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.append(
                     p.profiler.kineto_results.events())) as prof:
        warm()
        ctx.sync()
        prof.step()
        t0 = time.perf_counter()
        out = fn()
        ctx.sync()
        window = time.perf_counter() - t0
        prof.step()
    return out, got[0] if got else [], window


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _host_at(host, starts, t, walk: int = 4096) -> str:
    """The innermost host operation running at ``t``: host operations nest,
    so it is the latest-starting one that still runs."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - walk), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "host outside any operation"


def analyse(events, top: int = 10) -> dict:
    """busy_s, device_ops, kernels {name: seconds}, and the breakdown's
    device_ops and idle_gaps (at most ``top`` each, by seconds) of a
    window's profiler events."""
    dev, host = [], []
    for e in events:
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.is_user_annotation() or e.name().startswith(SPAN_PREFIX):
            # a record_function range, mirrored on the device's timeline
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                continue
            host.append(span)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(span)
        elif e.duration_ns() > 0:
            host.append(span)
    kernels = collections.Counter()
    for s, e, name in dev:
        kernels[name] += (e - s) / 1e9
    busy = _union([(s, e) for s, e, _ in dev]) / 1e9
    # idle gaps between the device's operations, each named by the
    # innermost host operation running at its middle
    gaps = collections.Counter()
    host.sort()
    starts = [h[0] for h in host]
    end = None
    for s, e, _ in sorted(dev):
        if end is not None and s > end:
            gaps[_host_at(host, starts, (s + end) / 2)] += (s - end) / 1e9
        end = e if end is None else max(end, e)
    return dict(
        busy_s=busy, device_ops=len(dev), kernels=dict(kernels),
        breakdown=dict(
            device_ops=[[k, v] for k, v in kernels.most_common(top)],
            idle_gaps=[[k, v] for k, v in gaps.most_common(top)]))


def kernel_seconds(rec: dict, pattern: str) -> float:
    """Device seconds of the operations whose name holds ``pattern``."""
    return sum(v for k, v in rec["kernels"].items() if pattern in k)
