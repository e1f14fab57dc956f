"""Arithmetic the per-layer readers (``splatbench/metrics/<name>.py``)
share.  Each takes the traced window's records: ``units`` (steps or frames)
in ``window_s`` seconds, the device's ``busy_s``, ``device_ops`` and
``kernels`` (seconds by operation name), the harness's ``spans`` (seconds
by name), the cell's ``config``, the reference's mean pair ``counts`` of a
unit (composited, stopping, visible, instances) and the ``work`` of one
unit counted from them.  A reader that finds nothing returns None and its
metric is left out."""
from __future__ import annotations

from splatbench.counts import work as counts
from splatbench.harness.trace import kernel_seconds

K1 = "composite_forward_kernel"
K2 = "composite_backward_kernel"


def mfu(rec: dict):
    """The unit's counted operations over its time in the window, as a
    share (%) of the fp32 peak."""
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    per_unit = rec["window_s"] / rec["units"]
    return rec["work"]["ops"] / per_unit / counts.FP32_OPS_PER_S * 100


def busy_ms(rec: dict):
    return rec["busy_s"] / rec["units"] * 1e3 if rec["busy_s"] > 0 else None


def idle_share(rec: dict):
    """The window's share (%) in which no device operation ran."""
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return (1.0 - rec["busy_s"] / rec["window_s"]) * 100


def device_ops(rec: dict):
    return rec["device_ops"] / rec["units"] if rec["device_ops"] else None


def roofline(rec: dict, key: str, pattern: str):
    """The least time of the counted ``work[key]`` over the device time a
    unit spent in operations named like ``pattern``, as a share (%)."""
    w = rec.get("work", {}).get(key)
    t = kernel_seconds(rec, pattern) / rec["units"]
    if not w or t <= 0:
        return None
    return counts.bound_s(w["bytes"], w["ops"], w["exps"])[0] / t * 100


def span_ms(rec: dict, name: str):
    """The mean of the harness's spans named ``name``, in ms."""
    v = rec["spans"].get(name)
    return sum(v) / len(v) * 1e3 if v else None
