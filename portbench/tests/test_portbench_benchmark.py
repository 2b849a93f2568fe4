"""BENCHMARK.json against the rules a benchmark file keeps: names, units and
lengths; every metric's reader, every configuration and traffic file
present; every per-layer metric's ``moves`` reported by each cell that
reports the metric; every cell with setup_s, another end-to-end metric and
a per-layer metric; the configurations as the port's factories state them."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import loader

ROOT = loader.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return loader.benchmark()


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16 and all(PATH.match(p) for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(loader.HERE, "traffic", w["traffic"] + ".json"))
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    assert len(json.dumps(bench)) <= 64 * 1024


def test_metrics(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(loader.HERE, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", ())) <= cells
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in e2e
        for c in cells:
            if loader.reports(m, c, bench):
                assert loader.reports(e2e[m["moves"]], c, bench), (m["name"], c)
    for c in cells:
        got = [m["name"] for m in loader.metrics(c, False)]
        assert "setup_s" in got and len(got) >= 2, c
        assert loader.metrics(c, True), c


def test_layers_agree(bench):
    layers = {}
    for m in bench["per_layer"]:
        base = m["name"].split(".")[0]
        layers.setdefault(base, set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("name,factory,kw", [
    ("fleetrec_model3", "fleetrec_model3", {"batch_size": 1024}),
    ("criteo_terabyte_int8", "criteo_terabyte",
     {"batch_size": 4096, "dtype": "float32", "table_dtype": "int8"}),
])
def test_configs_are_the_ports(name, factory, kw):
    from fleetrec_tpu_torch import config as C

    from portbench.model import port_config

    cfile = json.load(open(os.path.join(loader.HERE, "configs", f"{name}.json")))
    got = port_config(factory, cfile["model"], cfile["serve"])
    want = C.get_config(factory, **kw)
    for f in ("tables", "dense_dim", "batch_size", "dtype", "table_dtype", "onehot_max",
              "onehot_factor_max", "onehot_r2", "take_stripes", "take_lanes"):
        a, b = getattr(got, f), getattr(want, f)
        if f == "tables":
            a = [(t.table_id, t.rows, t.dim, t.out_offset) for t in a]
            b = [(t.table_id, t.rows, t.dim, t.out_offset) for t in b]
        assert a == b, f
    assert got.mlp.widths == want.mlp.widths
