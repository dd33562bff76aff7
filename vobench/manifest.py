"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration, traffic mix, the mix's driver and the cell's limits, and
each per-layer metric's reader."""

from __future__ import annotations

import functools
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@functools.lru_cache(maxsize=None)
def load() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def cell(name: str) -> dict:
    for w in load()["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(c: dict) -> dict:
    return _json("configs", c["config"] + ".json")


def traffic(c: dict) -> dict:
    return _json("traffic", c["traffic"] + ".json")


def limits(c: dict) -> dict:
    return _json("limits", c["name"] + ".json")


def _applies(metric: dict, c: dict, reported) -> bool:
    if "workloads" in metric:
        return c["name"] in metric["workloads"]
    return reported(metric)


def end_to_end(c: dict) -> list:
    return [m for m in load()["end_to_end"] if _applies(m, c, lambda m: True)]


def per_layer(c: dict) -> list:
    e2e = {m["name"] for m in end_to_end(c)}
    return [m for m in load()["per_layer"] if _applies(m, c, lambda m: m["moves"] in e2e)]


def unit(name: str) -> str:
    for m in load()["end_to_end"] + load()["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


def _module(kind: str, name: str):
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"vobench_{kind}_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader_file(name: str) -> str:
    """The file of a per-layer metric's reader: ``metrics/<name>.py``, or,
    where there is none, that of the name up to its first dot, so that
    ``device_idle_pct.lanes`` shares ``metrics/device_idle_pct.py``."""
    for stem in (name, name.split(".")[0]):
        if os.path.exists(os.path.join(HERE, "metrics", stem + ".py")):
            return stem
    raise FileNotFoundError(f"no reader for {name!r} under vobench/metrics")


def reader(name: str):
    """``read(ctx)`` of the metric's reader file."""
    return _module("metrics", reader_file(name)).read


def driver(traffic: dict):
    """The traffic mix's driver module, ``vobench/drivers/<driver>.py``."""
    return _module("drivers", traffic["driver"])
