"""BENCHMARK.json against the benchmark's rules, and every name in it
resolving to its files."""

import json
import os
import re

import pytest

from portbench import harness
from portbench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert len(bench["command"]) <= 32 and all(TEXT.match(w) for w in bench["command"])
    for word in bench["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        if os.sep in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_names_units_and_text(bench):
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["source"] in SOURCES
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(bench).encode()) <= 64 * 1024


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        names = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in names and len(names) >= 2
        layers = cell.per_layer()
        assert layers
        for m in layers:
            assert m["moves"] in names


def test_every_name_resolves_to_its_files(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert hasattr(cell.driver(), "run") and hasattr(cell.driver(), "readings")
        assert cell.reference().segmentor and cell.counts().train_calls
        assert set(cell.limits["limits"])
        for m in cell.per_layer():
            assert callable(cell.reader(m["name"]).read)
    for m in bench["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in bench["workloads"]}


def test_config_files_state_what_the_program_runs(bench):
    for w in bench["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        harness.Run(cell, 0, 0.0, False, None, 0.0).port_config()


def test_a_config_file_that_differs_from_the_program_is_refused(bench):
    cell = harness.load_cell(ROOT, bench["workloads"][0]["name"])
    cell.config = dict(cell.config, depths=[1, 1, 1, 1])
    with pytest.raises(ValueError, match="depths"):
        harness.Run(cell, 0, 0.0, False, None, 0.0).port_config()


def test_four_chip_cells_within_their_share(bench):
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
