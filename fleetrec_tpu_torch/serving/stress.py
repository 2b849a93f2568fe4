"""The ingest ring's stress test: ``native/stress_test.cpp`` (the port's
byte-equal copy of the JAX package's, the ``stress`` / ``stress_tsan``
targets of its Makefile) linked with the port's ``native/ingest.cpp`` and
``native/scatter.cpp`` into one executable in ``fleetrec_tpu_torch/_build/``
(once per source hash), then run:

    python -m fleetrec_tpu_torch.serving.stress [--tsan]

``--tsan`` builds with ThreadSanitizer (``g++ -O1 -g -fsanitize=thread``);
without it the build is ``-O3``.  The binary runs three phases over
localhost: 3 senders into a ring of 2 slots, each batch checked against
its senders' fill values; the striped loadgen (2 senders x 4 connections,
ramp-coded payloads); the scatter egress round-robin over 3 consumers, one
of them slow.  It listens on fixed ports (``STRESS_PORTS``), so ``run``
first waits until no other process holds them, and runs the binary again
(up to ``ATTEMPTS`` runs) where another process took one of them before
the binary bound it.  ``run`` raises unless the binary exits 0 within
``TIMEOUT_S`` and prints all three OK lines.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import time
from typing import Sequence

from ..ops._build import build_shared

_NATIVE_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            os.pardir, "native"))
SOURCES = tuple(os.path.join(_NATIVE_DIR, f)
                for f in ("ingest.cpp", "scatter.cpp", "stress_test.cpp"))
# (compile, link) flags: the Makefile's stress_tsan and stress targets
TSAN = (("g++", "-O1", "-g", "-std=c++17", "-fsanitize=thread", "-pthread"),
        ("g++", "-fsanitize=thread", "-pthread"))
PLAIN = (("g++", "-O3", "-std=c++17", "-Wall", "-pthread"), ("g++", "-pthread"))
# the ports stress_test.cpp binds: the 3-sender ring, the striped ring
# (2 senders x 4 connections), the scatter consumers
STRESS_PORTS = (*range(19080, 19083), *range(19200, 19208), *range(19400, 19403))
# a line each phase prints when it passed
OK_LINES = ("stress OK:", "striped stress OK:", "scatter stress OK:")
# what the binary prints to stderr where a port it listens on was taken
BIND_FAILED = re.compile(r"(bind|listen) failed")
TIMEOUT_S = 120.0  # the limit of one run of the binary
ATTEMPTS = 3  # runs of the binary where each one lost a port


def build(tsan: bool = True) -> str:
    """The stress executable's path, built at first use."""
    cmd, link = TSAN if tsan else PLAIN
    return build_shared("stress_test_tsan" if tsan else "stress_test", SOURCES, cmd, link,
                        suffix="")


def _busy(ports: Sequence[int]) -> list:
    """The ports of ``ports`` another socket holds (a bind with
    SO_REUSEADDR, as the binary's listeners, fails)."""
    busy = []
    for port in ports:
        with socket.socket() as s:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            try:
                s.bind(("0.0.0.0", port))
            except OSError:
                busy.append(port)
    return busy


def wait_for_ports(ports: Sequence[int] = STRESS_PORTS, timeout_s: float = 180.0) -> None:
    """Return once every port of ``ports`` is free; raise after ``timeout_s``."""
    t_end = time.monotonic() + timeout_s
    while True:
        busy = _busy(ports)
        if not busy:
            return
        if time.monotonic() > t_end:
            raise RuntimeError(f"the stress test's ports {busy} stayed in use for "
                               f"{timeout_s:.0f} s")
        time.sleep(0.25)


def run(tsan: bool = True, timeout_s: float = TIMEOUT_S) -> dict:
    """Build and run the stress test; returns its output lines, the build's
    and the last run's seconds and the number of runs.  Raises on a nonzero
    exit, a missing OK line or the time limit, and where every one of
    ``ATTEMPTS`` runs lost a port to another process."""
    t0 = time.perf_counter()
    exe = build(tsan)
    build_s = time.perf_counter() - t0
    for attempt in range(1, ATTEMPTS + 1):
        wait_for_ports()
        t1 = time.perf_counter()
        try:
            proc = subprocess.run([exe], capture_output=True, text=True, timeout=timeout_s)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"{os.path.basename(exe)} ran past {timeout_s} s; its output:\n"
                               f"{e.stdout or ''}{e.stderr or ''}") from None
        run_s = time.perf_counter() - t1
        if proc.returncode == 0 or not BIND_FAILED.search(proc.stderr):
            break
    lines = proc.stdout.splitlines()
    missing = [ok for ok in OK_LINES if not any(line.startswith(ok) for line in lines)]
    if proc.returncode != 0 or missing:
        raise RuntimeError(f"{os.path.basename(exe)} exited {proc.returncode} (run {attempt} "
                           f"of {ATTEMPTS}), missing {missing}:\n"
                           f"{proc.stdout}{proc.stderr[-6000:]}")
    return {"binary": exe, "tsan": tsan, "rc": proc.returncode, "lines": lines,
            "stderr": proc.stderr, "build_s": build_s, "run_s": run_s, "runs": attempt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tsan", action="store_true", help="build with ThreadSanitizer")
    args = ap.parse_args(argv)
    out = run(args.tsan)
    for line in out["lines"]:
        print(line)
    print(json.dumps({k: out[k] for k in ("binary", "tsan", "rc", "build_s", "run_s", "runs")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
