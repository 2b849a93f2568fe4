"""Finding a cell's parts by name: ``BENCHMARK.json`` at the root of the
checkout, the configuration file it names, ``traffic/<name>.json`` and a
metric's reader ``metrics/<name>.py``.  A later change adds a cell, a mix
or a metric by adding files and entries; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import List

from .serve import Cell

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def traffic(name: str, bench_dir: str = HERE) -> dict:
    with open(os.path.join(bench_dir, "traffic", f"{name}.json")) as f:
        return json.load(f)


def cell(name: str, root: str = ROOT, bench_dir: str = HERE) -> Cell:
    """The cell ``name`` of the benchmark with its configuration and mix."""
    bench = benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({sorted(wl)})")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return make_cell(name, w["config"], w["chips"], os.path.join(root, conf["file"]),
                     w["traffic"], bench_dir)


def make_cell(name: str, config: str, chips: int, config_file: str, traffic_name: str,
              bench_dir: str = HERE) -> Cell:
    """A cell of a configuration file and a traffic mix, named or not in
    ``BENCHMARK.json``."""
    with open(config_file) as f:
        cfile = json.load(f)
    return Cell(name=name, config=config, chips=chips, model=cfile["model"],
                serve=cfile["serve"], check=cfile["check"],
                traffic=traffic(traffic_name, bench_dir))


def reports(metric: dict, cell_name: str, bench: dict) -> bool:
    """Whether ``cell_name`` reports ``metric``: its ``workloads`` list, or
    without one, every cell (end to end) or every cell that reports the
    metric it moves (per layer)."""
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    if "moves" in metric:
        moved = {m["name"]: m for m in bench["end_to_end"]}[metric["moves"]]
        return reports(moved, cell_name, bench)
    return True


def metrics(cell_name: str, trace: bool, root: str = ROOT) -> List[dict]:
    bench = benchmark(root)
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if reports(m, cell_name, bench)]


def needs_trace(cell_name: str, root: str = ROOT) -> bool:
    """Whether an end-to-end metric of ``cell_name`` reads the device's
    trace, so that its untraced runs profile a stretch too."""
    return any(m["source"] == "device_trace" for m in metrics(cell_name, False, root))


def reader(name: str, bench_dir: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
