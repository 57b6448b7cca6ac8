"""``BENCHMARK.json`` against the contract's shape, every name resolved
to its file, and a cell added from a directory of its own."""
import json
import re

import pytest
import torch

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((harness.REPO / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]] + \
            [k for c in SPEC["configs"] for k in c["reduced"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for text in [e["why"] for e in SPEC["configs"] + SPEC["workloads"]] + \
            [m["layer"] for m in SPEC["per_layer"]] + \
            [c["source"] for c in SPEC["configs"]] + SPEC["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text \
            and "\t" not in text, text
    assert len(json.dumps(SPEC)) <= 64 * 1024
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    bench = harness.Bench()
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in bench.metrics(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert bench.metrics(w["name"], True)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_part_resolves_by_name(cell):
    bench = harness.Bench()
    ctx = harness.Context(bench, cell, 1, torch.device("cpu"))
    assert ctx.cfg["name"] == ctx.cell["config"]
    for kind in ("models", "reference", "costs"):
        assert ctx.module(kind)
    assert ctx.driver().Run
    assert bench.module("data", ctx.cfg["data"]).make
    for m in bench.metrics(cell, True):
        assert bench.module("metrics", m["name"]).read
    assert ctx.limits


def test_a_cell_added_by_files_alone(tiny):
    # the fixture's configurations, traffic and limits live only in its
    # own directory; its drivers, models and metrics are the benchmark's
    assert not (harness.HERE / "traffic" / "tiny_graph.json").exists()
    ctx = harness.Context(tiny, "tiny_dense.graph", 1, torch.device("cpu"))
    assert ctx.traffic["driver"] == "graph"
    assert ctx.limits and ctx.cfg["name"] == "tiny_dense"
