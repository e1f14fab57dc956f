"""What one cell is made of, found by name from ``BENCHMARK.json``: its
configuration file, its traffic mix (``splatbench/traffic/<traffic>.json``),
the limits of its correctness check (``splatbench/checks/<cell>.json``),
its end-to-end metrics and the readers of its per-layer metrics
(``splatbench/metrics/<metric>.py``).  A later cell, mix or metric is new
files and new entries; nothing here names one."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # the configuration file, with "name"
    traffic: dict       # the traffic mix's parameters, with "name"
    limits: dict        # number compared -> its limit
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list     # (entry, reader) pairs this cell reports


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str):
    """``read(rec)`` of ``splatbench/metrics/<name>.py``."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "splatbench.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(entry: dict, cell: str, e2e_names=None) -> bool:
    """Whether a metric entry is reported in ``cell``: listed there, or
    listing no cells and (for a per-layer one) moving an end-to-end metric
    the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry.get("moves") in e2e_names


def workloads(root: str = ROOT) -> list:
    """The names of the cells ``BENCHMARK.json`` lists."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    return [w["name"] for w in bench["workloads"]]


def unlisted(name: str) -> dict:
    """The workload entry of a one-chip cell ``<config>.<traffic>`` that
    ``BENCHMARK.json`` does not list (a look or a test at its size)."""
    config, traffic = name.split(".", 1)
    return dict(name=name, config=config, traffic=traffic, chips=1)


def load(name: str, root: str = ROOT, workload: dict = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; or, given ``workload`` (its
    ``config``, ``traffic`` and ``chips``), a cell that ``BENCHMARK.json``
    does not list, with the metrics that list it (none)."""
    bench = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload is None and name not in cells:
        raise SystemExit(f"splatbench: no workload {name!r} in BENCHMARK.json "
                         f"(has {', '.join(cells)})")
    w = workload or cells[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = dict(_read_json(os.path.join(root, cfg_entry["file"])),
                  name=w["config"])
    traffic = dict(_read_json(os.path.join(PKG, "traffic",
                                           f"{w['traffic']}.json")),
                   name=w["traffic"])
    limits = _read_json(os.path.join(PKG, "checks", f"{name}.json"))["limits"]
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [(m, reader(m["name"])) for m in bench["per_layer"]
                 if applies(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)
