"""The ingest ring's stress test (``fleetrec_tpu_torch/serving/stress.py``),
the port's counterpart of the JAX package's Makefile targets ``stress`` and
``stress_tsan``: the port's copies of ``ingest.cpp``, ``scatter.cpp`` and
``stress_test.cpp`` (held byte-equal to the JAX package's by
tests/test_torch_config.py) built with ThreadSanitizer and with ``-O3`` into
``fleetrec_tpu_torch/_build/`` and run on this host: rc 0 and the three OK
lines (3 senders, the striped loadgen, the scatter egress with a slow
consumer), each run under a 120 s limit.  A failed run, a missing OK line,
the limit and a port held by another process each raise.  Without ``g++``
the build tests skip and say so."""

import json
import os
import pathlib
import shutil
import socket
import stat

import pytest

from fleetrec_tpu_torch.ops import _build
from fleetrec_tpu_torch.serving import stress

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_PKG = REPO / "fleetrec_tpu_torch"
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no g++ on this host: the stress test cannot be built")


def _port_files():
    """Every file of the port's package outside its build directory and
    the interpreter's caches."""
    build = pathlib.Path(_build.BUILD_DIR)
    return {p for p in PORT_PKG.rglob("*")
            if p.is_file() and build not in p.parents and "__pycache__" not in p.parts}


@needs_gxx
@pytest.mark.parametrize("tsan", [True, False], ids=["tsan", "O3"])
def test_stress_test_builds_into_build_dir_and_passes(tsan, monkeypatch, capsys):
    """The TSan build runs through the module's entry point (``--tsan``),
    the -O3 build through ``run``: the binary is started once a mode."""
    before = _port_files()
    native = sorted(os.listdir(stress._NATIVE_DIR))
    if tsan:
        runs, real_run = [], stress.run
        monkeypatch.setattr(stress, "run", lambda *a, **k: runs.append(real_run(*a, **k)) or runs[-1])
        assert stress.main(["--tsan"]) == 0
        (out,) = runs
        lines = capsys.readouterr().out.splitlines()
        assert [line.split(":")[0] + ":" for line in lines[:3]] == list(stress.OK_LINES)
        summary = json.loads(lines[-1])
        assert summary["rc"] == 0 and summary["tsan"] is True
        assert summary["binary"] == out["binary"]
    else:
        out = stress.run(tsan=False)
    assert out["rc"] == 0
    for ok in stress.OK_LINES:
        assert any(line.startswith(ok) for line in out["lines"]), (ok, out["lines"])
    assert "ThreadSanitizer" not in out["stderr"], out["stderr"][-4000:]
    exe = pathlib.Path(out["binary"])
    assert exe.parent == pathlib.Path(_build.BUILD_DIR)
    assert exe.name.startswith("stress_test_tsan-" if tsan else "stress_test-")
    assert os.stat(exe).st_mode & stat.S_IXUSR
    # the build writes nothing outside the build directory
    assert sorted(os.listdir(stress._NATIVE_DIR)) == native == [
        "ingest.cpp", "scatter.cpp", "stress_test.cpp"]
    assert _port_files() == before


# a fake binary's output that passes
_OK = "echo 'stress OK: 1'; echo 'striped stress OK: 1'; echo 'scatter stress OK: 1'"


def _script(tmp_path, body):
    path = tmp_path / "fake_stress"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(0o755)
    return str(path)


@pytest.mark.parametrize("body,match", [
    ("echo 'stress OK: 1 batches'; echo 'striped stress OK: 1 batches'", "missing"),
    (f"{_OK}; exit 1", "exited 1"),
    ("sleep 5", "ran past"),
], ids=["missing_line", "nonzero_exit", "time_limit"])
def test_a_failed_run_raises(tmp_path, monkeypatch, body, match):
    monkeypatch.setattr(stress, "build", lambda tsan=True: _script(tmp_path, body))
    monkeypatch.setattr(stress, "wait_for_ports", lambda: None)
    with pytest.raises(RuntimeError, match=match):
        stress.run(timeout_s=1.0)


@pytest.mark.parametrize("losses", [1, stress.ATTEMPTS - 1, stress.ATTEMPTS])
def test_a_run_that_lost_a_port_runs_again(tmp_path, monkeypatch, losses):
    """A run whose listener lost its port to another process (stress_test.cpp's
    "bind failed" / "listen failed") is run again after the wait for the
    ports, up to ATTEMPTS runs; the last failure raises."""
    count = tmp_path / "runs"
    body = (f"echo x >> {count}; if [ $(wc -l < {count}) -le {losses} ]; then "
            f"echo 'scatter consumer 0 bind failed' >&2; exit 1; fi; {_OK}")
    monkeypatch.setattr(stress, "build", lambda tsan=True: _script(tmp_path, body))
    waits = []
    monkeypatch.setattr(stress, "wait_for_ports", lambda: waits.append(1))
    if losses < stress.ATTEMPTS:
        out = stress.run(timeout_s=5.0)
        assert out["rc"] == 0 and out["runs"] == losses + 1
    else:
        with pytest.raises(RuntimeError, match=f"exited 1 \\(run {losses} of {losses}\\)"):
            stress.run(timeout_s=5.0)
    assert len(count.read_text().split()) == len(waits) == min(losses + 1, stress.ATTEMPTS)


def test_a_held_port_is_waited_for_then_raises():
    with socket.socket() as s:
        s.bind(("0.0.0.0", 0))
        s.listen(1)
        port = s.getsockname()[1]
        assert stress._busy([port]) == [port]
        with pytest.raises(RuntimeError, match="stayed in use"):
            stress.wait_for_ports([port], timeout_s=0.5)
    assert stress._busy([port]) == []
    stress.wait_for_ports([port], timeout_s=0.5)


def test_stress_ports_are_the_ones_the_binary_binds():
    """STRESS_PORTS lists every port stress_test.cpp binds."""
    src = pathlib.Path(stress.SOURCES[2]).read_text()
    for base, n in ((19080, 3), (19200, 8), (19400, 3)):
        assert f"PORT = {base}" in src
        assert set(range(base, base + n)) <= set(stress.STRESS_PORTS)
    assert len(stress.STRESS_PORTS) == 14
    # its messages for a port it could not take are the ones run retries on
    for msg in ("scatter consumer %d bind failed", "striped listen failed", '"listen failed'):
        assert msg in src and stress.BIND_FAILED.search(msg)
