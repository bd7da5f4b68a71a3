"""BENCHMARK.json against the contract's characters and shapes, and every
name it uses against a file of the benchmark."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_paths(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(man["command"]) <= 32
    assert all(_line(w) for w in man["command"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    cells = 24
    assert (2 + 14 * cells) * (man["run_seconds"] + 60) \
        + cells * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 65536


def test_names_and_units(man):
    names = [c["name"] for c in man["configs"]] + \
        [w["name"] for w in man["workloads"]] + \
        [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(c["name"] for c in man["configs"])) == len(man["configs"])
    assert len(set(w["name"] for w in man["workloads"])) == \
        len(man["workloads"])
    metrics = man["end_to_end"] + man["per_layer"]
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs(man):
    files = set()
    used = {w["config"] for w in man["workloads"]}
    assert 1 <= len(man["configs"]) <= 24
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in man["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in cfg
            assert not k.endswith(("_dim", "_rank", "_len"))


def test_workloads(man):
    assert 1 <= len(man["workloads"]) <= 24
    pairs = set()
    four = 0
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
    assert four <= max(1, len(man["workloads"]) // 4)


def test_metrics(man):
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    cells = {w["name"] for w in man["workloads"]}
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m.get("workloads", [])) <= cells
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(
            ROOT, "benchmark", "metrics", m["name"] + ".py")), m["name"]
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    for w in cells:
        mine = [m for m in man["end_to_end"]
                if w in m.get("workloads", [w])]
        assert len(mine) >= 2
        assert any(w in m.get("workloads", [w]) for m in man["per_layer"])
