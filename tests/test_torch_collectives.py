"""The port's collective bandwidth bench (``fleetrec_tpu_torch/benchmarks/
collectives.py::ici_bench``) and ``cli icibench``, the twins of
tests/test_ops.py:69 and tests/test_cli.py:72, and the port's multi-device
dry run (``parallel/dryrun.py``), the twin of ``__graft_entry__.py::
dryrun_multichip``, in gloo worlds of CPU ranks (tests/torch_worlds.py).
On the CPU the timings are host clock over gloo: the tests check the keys
and that every rate is positive, not the rates."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from fleetrec_tpu_torch.benchmarks import ici_bench
from fleetrec_tpu_torch.parallel import single_device_mesh
from torch_variants import CPU
from torch_worlds import run_dryrun, run_ici_bench, spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("all_gather", "psum", "ppermute")


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)], ids=["1x2", "1x4", "2x2"])
def test_ici_bench_runs_on_mesh(tmp_path, shape):
    D, M = shape
    res = spawn_world(D * M, run_ici_bench, (D, M, 1), tmp_path)
    for r in res:
        assert r["model_axis"] == M and r["per_device_mbytes"] == 1.0
        assert "note" not in r
        for op in OPS:
            assert r[op]["GB_s"] > 0 and r[op]["ms"] > 0


def test_ici_bench_on_one_rank_notes_no_collective():
    r = ici_bench(single_device_mesh(CPU), mbytes=1, iters=2)
    assert r == {"model_axis": 1, "per_device_mbytes": 1.0,
                 "note": "single device: collectives are no-ops"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH", "")]))
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_cli_icibench_as_processes(tmp_path):
    """`cli icibench --data 2 --procs 4 --backend gloo` as four OS
    processes, one a rank: rank 0 prints the JSON, the others nothing."""
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fleetrec_tpu_torch.cli", "icibench", "--device", CPU,
         "--data", "2", "--mbytes", "1", "--iters", "2", "--procs", "4", "--proc-id", str(r),
         "--coordinator", init, "--backend", "gloo"],
        cwd=REPO, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-3000:]
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    r = json.loads(outs[0].splitlines()[-1])
    assert r["model_axis"] == 2 and r["backend"] == "gloo" and r["device"] == "cpu"
    for op in OPS:
        assert r[op]["GB_s"] > 0
    assert outs[1:] == ["", "", ""]


def test_cli_icibench_one_process(capsys):
    from fleetrec_tpu_torch import cli

    cli.main(["icibench", "--device", CPU, "--mbytes", "1", "--iters", "2"])
    r = json.loads(capsys.readouterr().out.strip())
    assert r["model_axis"] == 1 and "note" in r


def test_cli_icibench_world_must_match_the_mesh():
    from fleetrec_tpu_torch import cli

    with pytest.raises(SystemExit, match="needs --procs 4"):
        cli.main(["icibench", "--device", CPU, "--data", "2", "--model-axis", "2"])


def test_dryrun_multichip_on_2x2(tmp_path):
    """The dry run on a (2, 2) world: every rank runs it to the end; the
    ranks of a data row agree on every score, all ranks on the loss, and
    each row's pipelined batches are its forward's."""
    res = spawn_world(4, run_dryrun, (2, 2), tmp_path)
    assert len({r["loss"] for r in res}) == 1 and np.isfinite(res[0]["loss"])
    for d in range(2):
        a, b = res[2 * d], res[2 * d + 1]
        assert a["mesh"] == [2, 2]
        for k in ("scores_f32", "scores_int8", "scores_pipelined", "scores_criteo"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["scores_int8"].shape == (16,)  # 8 rows a rank, 2 data rows
    # the two data rows score different rows of the batch
    assert not np.array_equal(res[0]["scores_criteo"], res[2]["scores_criteo"])


def test_dryrun_multichip_one_device():
    from fleetrec_tpu_torch.parallel import dryrun_multichip

    out = dryrun_multichip(single_device_mesh(CPU))
    assert out["mesh"] == [1, 1] and out["scores_criteo"].shape == (8,)
