"""The loader finds a configuration, a traffic mix and a metric by name
alone: a throwaway benchmark in a temporary directory, with files of its
own, runs through the same code."""

from __future__ import annotations

import json
import os
import time

from portbench import loader, serve
from portbench.tests import tiny


def test_throwaway_cell_and_metric(tmp_path):
    bench_dir = tmp_path / "bench"
    for d in ("configs", "traffic", "metrics"):
        (bench_dir / d).mkdir(parents=True)
    c = tiny.cell(1)
    (bench_dir / "configs" / "tiny_cfg.json").write_text(json.dumps(
        {"model": c.model, "serve": c.serve, "check": c.check}))
    (bench_dir / "traffic" / "burst.json").write_text(json.dumps(c.traffic))
    (bench_dir / "metrics" / "answered.stream.py").write_text(
        "def read(out):\n    return float(len(out.replies))\n")
    (bench_dir / "metrics" / "nothing.stream.py").write_text(
        "def read(out):\n    return None\n")
    bench = {
        "configs": [{"name": "tiny_cfg", "file": "bench/configs/tiny_cfg.json"}],
        "workloads": [{"name": "tiny.burst", "config": "tiny_cfg", "traffic": "burst",
                       "chips": 1}],
        "end_to_end": [{"name": "qps", "unit": "queries/s"}],
        "per_layer": [{"name": "answered.stream", "unit": "batches", "moves": "qps"},
                      {"name": "nothing.stream", "unit": "batches", "moves": "qps"}],
    }
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = loader.cell("tiny.burst", root=str(tmp_path), bench_dir=str(bench_dir))
    assert cell.traffic == c.traffic and cell.model == c.model
    names = [m["name"] for m in loader.metrics("tiny.burst", True, root=str(tmp_path))]
    assert names == ["answered.stream", "nothing.stream"]
    out = serve.run_single(cell, 12345, 0.3, False, time.monotonic_ns(), device="cpu")
    assert serve.correct(out), out.checks
    read = loader.reader("answered.stream", bench_dir=str(bench_dir))
    assert read(out) == len(out.replies) > 0
    assert loader.reader("nothing.stream", bench_dir=str(bench_dir))(out) is None
    assert os.path.exists(bench_dir / "metrics" / "answered.stream.py")
