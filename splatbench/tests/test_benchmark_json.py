"""``BENCHMARK.json`` against the benchmark's contract, as far as a file can
show it: its keys, names and limits, every metric reported where it is
listed, and every cell's configuration, mix, checks and readers found by
name."""
import json
import os
import re

from conftest import ROOT
from splatbench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_names_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    metrics = b["end_to_end"] + b["per_layer"]
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}, c["name"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"]), c["name"]
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}, w["name"]
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}, m["name"]
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}, m["name"]
    for text in ([e["why"] for e in b["configs"] + b["workloads"]]
                 + [c["source"] for c in b["configs"]]
                 + [m["layer"] for m in b["per_layer"]] + b["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    for entry in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in b[kind]]
        assert len(names) == len(set(names))
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= 1


def test_every_cell_reports_what_it_lists():
    b = _bench()
    cells = {w["name"] for w in b["workloads"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]
    e2e = {m["name"] for m in b["end_to_end"]}
    for name in cells:
        cell = spec.load(name)
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2, name
        assert cell.per_layer, name
        for m, _ in cell.per_layer:
            assert m["moves"] in e2e and m["moves"] in got, (name, m["name"])
        assert cell.limits, name
