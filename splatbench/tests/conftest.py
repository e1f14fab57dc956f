"""The benchmark's own tests: ``python -m pytest splatbench/tests -q`` from
the root of a checkout.  They run on the CPU at small sizes; tests marked
``card`` need a CUDA card and skip without one."""
import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")


def tiny(name: str, n: int = 3000):
    """The cell ``name`` of BENCHMARK.json cut to a CPU test's size: a
    128x96 frame, the asset's first ``n`` gaussians (split as the
    configuration says), two-iteration chunks, four viewer poses; its
    limits are the cell's own."""
    from splatbench.harness import spec
    # a viewer cell is built from its configuration and mix; BENCHMARK.json
    # does not list one (PERF.md, Open questions)
    cell = spec.load(name, workload=spec.unlisted(name)
                     if name.endswith(".view") else None)
    cfg = copy.deepcopy(cell.config)
    splits = cfg["scene"]["splits"]
    cfg.update(name="tiny_" + cfg["name"], width=128, height=96,
               num_gaussians=n << splits, train_slots=2 * (n << splits))
    cfg["scene"]["take"] = n
    mix = copy.deepcopy(cell.traffic)
    if mix["kind"] == "train":
        mix["chunk"] = 2
    else:
        mix["poses"]["count"] = 4
        mix.update(trace_frames=4, sample_range=4, samples=2)
    return cell._replace(config=cfg, traffic=mix)


def run_tiny(name: str, trace: bool = False, seed: int = 2**31 + 5,
             n: int = 3000):
    import time
    from splatbench.harness import bench
    return bench.run_cell(tiny(name, n), seed, 0.5, trace, "cpu",
                          time.perf_counter(), budget=1 << 22)
