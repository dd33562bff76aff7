"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

import json
import os
import re

import pytest

from vobench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths(bench):
    assert set(bench) == TOP
    assert os.path.getsize(os.path.join(manifest.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in names


def test_every_cell_reports_what_it_must(bench):
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for w in bench["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(w)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = manifest.per_layer(w)
        assert layer
        for m in layer:  # the metric it moves is one the cell reports
            assert m["moves"] in e2e


def test_files_resolve_by_name(bench):
    for w in bench["workloads"]:
        cfg = manifest.config(w)
        tr = manifest.traffic(w)
        lim = manifest.limits(w)
        assert cfg["name"] == w["config"]
        mod = manifest.driver(tr)
        assert all(callable(getattr(mod, f)) for f in ("make", "numbers", "control"))
        assert lim["numbers"] and all("limit" in v for v in lim["numbers"].values())
        for m in manifest.per_layer(w):
            assert callable(manifest.reader(m["name"]))
    files = {c["file"] for c in bench["configs"]}
    assert len(files) == len(bench["configs"])
    for c in bench["configs"]:
        with open(os.path.join(manifest.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["source"] and body["precision"] and "assumed" in body
        assert body["reduced"] == c["reduced"]


def test_run_seconds_fit_the_full_check(bench):
    """2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s of compiling a
    cell and 1200 s spare, for the 24 cells a manifest may grow to."""
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
