"""Whole runs of the harness on the CPU at a tiny size (the port's kernels
have plain CPU versions; the native ingest tier builds with g++): the
served path, the load generator, the reference.  A sound run reads
``correct``; a planted fault, and the control in the program's place, read
not correct."""

from __future__ import annotations

import time

import pytest

from portbench import loader, serve
from portbench.tests import faults, tiny

SEED = 4_000_000_001  # past 2**31: seeds need not fit in 32 bits


def _run(cell, **kw):
    return serve.run_single(cell, SEED, 0.5, False, time.monotonic_ns(), device="cpu", **kw)


@pytest.mark.parametrize("senders", [3, 1])
def test_sound_run_is_correct(senders):
    out = _run(tiny.cell(senders))
    assert serve.correct(out), out.checks
    assert out.checks["max_err"]["value"] < 1e-5
    assert len(out.window()) > 0
    assert out.setup_s > 0
    assert loader.reader("qps.stream")(out) > 0
    assert loader.reader("to_submit_ms.stream")(out) > 0


def test_altered_answer_is_not_correct():
    from fleetrec_tpu_torch.models import FleetRecModel

    forward = FleetRecModel.forward
    try:
        out = _run(tiny.cell(3), patch=faults.altered_answer)
    finally:
        FleetRecModel.forward = forward
    assert not serve.correct(out)
    assert out.checks["max_err"]["value"] > out.checks["max_err"]["limit"]


def test_control_in_the_programs_place_is_not_correct():
    from fleetrec_tpu_torch.models import fleetrec

    mlp_apply = fleetrec.mlp_apply
    try:
        out = _run(tiny.cell(3), patch=faults.tf32_tower)
    finally:
        fleetrec.mlp_apply = mlp_apply
    assert out.checks["unanswered"]["value"] == 0 and out.checks["wire_errors"]["value"] == 0
    assert not serve.correct(out)
    assert out.checks["max_err"]["value"] > out.checks["max_err"]["limit"]
