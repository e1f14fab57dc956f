"""``harness/port_spans.py``: the attribution of device operations to the
port's spans on hand-made profiler events, a tiny training cell's port
record on the CPU, and the port's tracing left off by the cell's untraced
and traced runs."""
import pytest

from conftest import run_tiny, tiny
from splatbench.harness import port_spans

MAIN, ENGINE = 1, 2


def _row(name, start, end, thread=MAIN, corr=0, linked=0, seq=-1, fwd=0,
         dev=False):
    return (name, dev, start, end, thread, corr, linked, seq, fwd)


def _events():
    """One iteration on the host: K3 launched through ctypes (no framework
    operation around it) in ``rasterize.binning``; a multiply in
    ``step.losses`` that makes autograd node 7 (an operation before it in
    ``rasterize.binning`` carries the same number); node 7's backward on the
    engine's thread while the Trainer's thread waits in ``step.backward``;
    and a fill launched after the iteration, outside every span."""
    g = port_spans.PREFIX
    return [
        _row(g + "iter", 0, 1000, corr=1),
        _row(g + "rasterize.binning", 10, 100, corr=2),
        _row("cudaLaunchKernel", 20, 25, corr=501),
        # carries the number node 7 will take, and makes no node
        _row("aten::add_", 50, 55, corr=9, seq=7),
        _row("expand_kernel", 200, 300, corr=501, dev=True),
        _row(g + "step.losses", 100, 200, corr=3),
        _row("aten::mul", 110, 120, corr=4, seq=7),
        _row("cudaLaunchKernel", 112, 115, corr=502, linked=4),
        _row("mul_kernel", 300, 350, corr=502, linked=4, dev=True),
        _row(g + "step.backward", 200, 900, corr=5),
        _row("autograd::engine::evaluate_function: MulBackward0", 300, 400,
             thread=ENGINE, corr=6, seq=7, fwd=MAIN),
        _row("aten::mul", 310, 320, thread=ENGINE, corr=7),
        _row("cudaLaunchKernel", 312, 314, thread=ENGINE, corr=503,
             linked=7),
        _row("mul_kernel", 400, 450, corr=503, linked=7, dev=True),
        _row("aten::zeros", 1100, 1110, corr=8),
        _row("cudaLaunchKernel", 1102, 1104, corr=504, linked=8),
        _row("fill_kernel", 1200, 1210, corr=504, linked=8, dev=True),
    ]


def test_attribution_of_hand_made_events():
    a = port_spans.attribute(_events(), units=1)
    ns = {k: round(v * 1e6) for k, v in a["device_ms"].items()}
    # the ctypes launch by its runtime call, the backward multiply by its
    # node's sequence number (not the waiting thread's step.backward), the
    # fill outside every span unattributed
    assert ns == {"rasterize.binning": 100, "step.losses": 100}
    assert round(a["unattributed_ms"] * 1e6) == 10
    assert {k: round(v * 1e6) for k, v in a["rules_ms"].items()} == {
        "span": 150, "sequence": 50, "outside": 10}
    assert round(a["device_op_ms"] * 1e6) == 210
    assert round(a["busy_ms"] * 1e6) == 210
    # the idle gaps at 350-400 and 450-1200 both fall in step.backward
    assert [k for k, _ in a["idle_gaps"]] == ["step.backward"]
    assert round(a["idle_gaps"][0][1] * 1e9) == 800


def test_timeline_innermost():
    tl = port_spans.Timeline([(0, 100, "a"), (10, 20, "b"), (30, 60, "c"),
                              (40, 50, "d"), (200, 300, "e")])
    want = {5: "a", 15: "b", 25: "a", 35: "c", 45: "d", 55: "c", 70: "a",
            150: None, 250: "e", 400: None}
    assert {t: tl.at(t) for t in want} == want


def test_tiny_cell_port_numbers_on_the_cpu():
    """The host's numbers come from the spans and counters; the device's
    are left out, with no device operation in the window."""
    from gsplat_tpu_torch import tracing
    res, rows = port_spans.run(tiny("trained262k.train"), 2**31 + 7, "cpu",
                               budget=1 << 22)
    got = res["numbers"]
    assert set(got) == {"dispatch_ms", "sync_wait_ms", "host_syncs"}
    assert got["dispatch_ms"] > 0 and got["sync_wait_ms"] >= 0
    assert got["host_syncs"] > 0
    assert res["port"]["device_op_ms"] == 0 and rows
    assert min(res["port"]["host_self_ms"].values()) >= 0
    assert not tracing.enabled() and tracing.take()["spans"] == []


@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_leave_the_port_tracing_off(trace, monkeypatch):
    from gsplat_tpu_torch import tracing
    from gsplat_tpu_torch.train.trainer import Trainer
    seen = []
    train = Trainer.train

    def spy(self, *a, **k):
        seen.append(tracing.enabled())
        return train(self, *a, **k)

    monkeypatch.setattr(Trainer, "train", spy)
    res = run_tiny("trained262k.train", trace=trace)
    assert res["correct"] and seen and not any(seen)


@pytest.mark.card
def test_port_numbers_on_the_card(card):
    """Every number non-null; the device ms put down to spans, with the
    unattributed ms, come within 1% of the busy ms of the same window (the
    union of its device operations, which a double count or operations
    overlapping on two streams would exceed); under 5% of it is
    unattributed, and the five layers hold 80% of it at the least."""
    import json
    import subprocess
    import sys

    from conftest import ROOT
    out = subprocess.run(
        [sys.executable, "-m", "splatbench.harness.port_spans",
         "--workload", "trained262k.train", "--seed", str(2**31 + 19)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    port, got = res["port"], res["numbers"]
    assert set(got) == set(port_spans.NUMBERS)
    assert all(v is not None and v >= 0 for v in got.values())
    busy = port["busy_ms"]
    parts = sum(port["device_ms"].values()) + port["unattributed_ms"]
    assert abs(parts - busy) <= 0.01 * busy
    assert port["unattributed_ms"] < 0.05 * busy
    layers = sum(got[k] for k in port_spans.LAYERS)
    assert layers >= 0.8 * busy
