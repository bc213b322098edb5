"""The harness finds every configuration, workload and metric by name, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark()


def test_every_cell_finds_its_config_workload_and_driver(bench):
    for entry in bench["workloads"]:
        cfg = harness.config(bench, entry["config"])
        wl = harness.workload(entry["name"])
        assert cfg["name"] == entry["config"]
        assert wl["chips"] == entry["chips"] == 1
        assert wl["why"] and len(entry["why"]) <= 200
        assert hasattr(harness.driver(wl["kind"]), "run")


def test_every_metric_has_a_reader_and_every_cell_reports_enough(bench):
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.reader(m["name"]))
    for entry in bench["workloads"]:
        e2e = [m["name"] for m in harness.metrics_of(bench, entry["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_of(bench, entry["name"], True)


def test_benchmark_json_keeps_the_contract(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    cells = [w["name"] for w in bench["workloads"]]
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for name in names + cells + metrics:
        assert NAME.match(name), name
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(metrics)) == len(metrics)
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(cells)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert 0.01 <= e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e and "bound" not in m
        for cell in m.get("workloads", cells):
            moved = harness.metrics_of(bench, cell, False)
            assert m["moves"] in [x["name"] for x in moved]
    assert len(json.dumps(bench)) < 64 * 1024
