"""The control (the reference one precision below the configuration's)
fails each cell's limit, on three seeds, at the published widths and a
batch the CPU holds (the chip's readings at the cells' own sizes are
``control.py``'s, recorded in PERF.md)."""

from __future__ import annotations

import pytest
import torch

from portbench import control, loader

WORKLOADS = [w["name"] for w in loader.benchmark()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("seed", [101, 2_200_000_003, 7])
def test_control_fails_the_limit(workload, seed):
    cell = loader.cell(workload)
    err = control.reading(cell, seed, torch.device("cpu"), pool=2, batch=64)
    assert err > cell.check["max_err"], err
