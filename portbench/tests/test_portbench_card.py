"""On the card (marked ``cuda``; skipped without one, decided in a
fixture): the control at each cell's own size on three seeds fails its
limit, and a short run of each one-card cell is correct.  Run on the card
with ``python3 -m pytest -q portbench/tests/test_portbench_card.py``."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import control, loader


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels have no CPU mode)")
    return torch.device("cuda")


WORKLOADS = [w["name"] for w in loader.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_at_the_cell_size(card, workload):
    cell = loader.cell(workload)
    for seed in (301, 302, 3_000_000_303):
        assert control.reading(cell, seed, card) > cell.check["max_err"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_short_run_is_correct(card, workload):
    r = subprocess.run([sys.executable, os.path.join(loader.HERE, "run.py"), "--workload",
                        workload, "--seed", "2718281828", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=loader.ROOT, timeout=1200)
    assert r.returncode == 0, r.stderr[-3000:]
    assert json.loads(r.stdout.strip().splitlines()[-1])["correct"]
