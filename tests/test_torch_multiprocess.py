"""Multi-process serving of the port over ``torch.distributed`` (gloo on the
CPU), the twins of tests/test_multiprocess.py:69, :88, :192, :293,
tests/test_multisender.py:200 (``serve --mesh`` with three senders) and
tests/test_compose.py:23, :32, :42, :63, and ``init_distributed``'s binding
of the rank's card.

Where the JAX package gives each process several devices of a global mesh,
the port gives each rank one device, so a (data, model) mesh is data *
model processes: ``cli serve --mesh D,M --procs D*M``.  Each data row's
leader (model rank 0) binds its own ingest port and replies its own rows;
the row's other ranks follow it.  Every world rendezvouses through a
``file://`` path under the test's directory, takes its ports from the
system, and runs under a deadline that kills it."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu_torch import cli
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.parallel import init_distributed
from fleetrec_tpu_torch.parallel.multihost import check_backend
from fleetrec_tpu_torch.serving import ServeSpec, build_engine
from fleetrec_tpu_torch.serving.engine import EXIT_PEER_TIMEOUT, PeerWatchdog
from fleetrec_tpu_torch.serving.wire import IndexWireFormat
from torch_variants import CPU
from torch_worlds import run_cases, spawn_world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH", "")]))
    env["OMP_NUM_THREADS"] = "1"  # several ranks share the CPU
    return env


def _free_ports(n, span=1):
    """``n`` port bases, each the first of ``span`` consecutive ports that
    are free now (a leader with S senders binds base .. base + S - 1)."""
    bases = []
    while len(bases) < n:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        if base + span > 65536 or any(abs(base - b) < span for b in bases):
            continue
        socks = []
        try:
            for port in range(base, base + span):
                socks.append(socket.socket())
                socks[-1].bind(("127.0.0.1", port))
            bases.append(base)
        except OSError:
            pass
        finally:
            for s in socks:
                s.close()
    return bases


def _serve_world(tmp, D, M, B_loc, batches, extra, senders=1):
    """``cli serve --mesh D,M --procs D*M`` as D*M OS processes; returns
    (processes, each leader's port base by data row)."""
    n = D * M
    ports = _free_ports(D, senders)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fleetrec_tpu_torch.cli", "serve", "--device", "cpu",
         "--config", "micro_test", "--batch", str(B_loc), "--batches", str(batches),
         "--mesh", f"{D},{M}", "--procs", str(n), "--proc-id", str(r),
         "--coordinator", f"file://{tmp}/rendezvous", "--backend", "gloo",
         "--port", str(ports[r // M]), "--slots", "8", "--senders", str(senders), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env(), text=True)
        for r in range(n)]
    return procs, ports


def _wait_banners(procs, M, deadline):
    """Each leader's "serving" banner and each follower's "following" line
    (model build and port bind done)."""
    for r, p in enumerate(procs):
        want = "serving" if r % M == 0 else "following"
        line = ""
        while not line.startswith(want):
            if time.monotonic() > deadline:
                raise AssertionError(f"rank {r}: no {want!r} line before the deadline")
            line = p.stdout.readline()
            if not line and p.poll() is not None:
                raise AssertionError(f"rank {r} exited {p.returncode}:\n{p.stderr.read()[-3000:]}")


def _client(port, payloads, n_scores, out, key):
    """Send each batch's payloads, one a sender, to ports port, port + 1,
    ...; read the replies on the first connection."""
    socks = [socket.create_connection(("127.0.0.1", port + s), timeout=60)
             for s in range(len(payloads[0]))]
    try:
        for batch in payloads:
            for sock, data in zip(socks, batch):
                sock.sendall(data)
        want, buf = n_scores * 4, b""
        while len(buf) < want:
            chunk = socks[0].recv(want - len(buf))
            if not chunk:
                break
            buf += chunk
    finally:
        for sock in socks:
            sock.close()
    out[key] = np.frombuffer(buf, np.float32)


def _finish(procs, deadline):
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _serve_and_check(tmp, D, M, B_loc, NB, tables, mlp, dense_fn, compare, extra=(),
                     senders=1):
    """Serve NB batches of D * B_loc rows on a (D, M) world; data row d's
    leader gets rows [d * B_loc, (d + 1) * B_loc) of each (from ``senders``
    senders: the wire of serving/wire.IndexWireFormat); the replied scores,
    joined, are held against the oracle by ``compare``."""
    cfg = JC.micro_test(batch_size=D * B_loc)
    wire = (IndexWireFormat.plan(TC.micro_test(batch_size=B_loc), B_loc, senders)
            if senders > 1 else None)
    deadline = time.monotonic() + 240
    procs, ports = _serve_world(tmp, D, M, B_loc, NB,
                                ["--table-scheme", tables, "--mlp-scheme", mlp, "--reply", *extra],
                                senders)
    try:
        _wait_banners(procs, M, deadline)
        rng = np.random.default_rng(11)
        g_idx = [np.stack([rng.integers(0, t.rows, D * B_loc) for t in cfg.tables], 1)
                 .astype(np.int32) for _ in range(NB)]
        g_dense = [dense_fn(rng.uniform(-1, 1, (D * B_loc, cfg.dense_dim))).astype(np.float32)
                   for _ in range(NB)]
        scores = {}
        rows = [slice(d * B_loc, (d + 1) * B_loc) for d in range(D)]
        threads = [threading.Thread(target=_client, daemon=True, args=(
            ports[d], [[g_idx[k][rows[d]].tobytes() + g_dense[k][rows[d]].tobytes()]
                       if senders == 1 else wire.payloads(g_idx[k][rows[d]], g_dense[k][rows[d]])
                       for k in range(NB)],
            NB * B_loc, scores, d)) for d in range(D)]
        for t in threads:
            t.start()
        outs = _finish(procs, deadline)
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    tabs, ws = jref.init_tables(cfg, scheme=tables), jref.init_mlp_weights(cfg, scheme=mlp)
    got = np.stack([scores[d].reshape(NB, B_loc) for d in range(D)], 1).reshape(NB, -1)
    for k in range(NB):
        compare(got[k], jref.forward(cfg, tabs, ws, g_idx[k], g_dense[k]))
    return outs


def test_two_row_sharded_forward(tmp_path):
    """A (2, 2) world: each data row's leader feeds its 8 rows of the
    16-row batch through host_local_batch_to_global, and each row's scores
    match the float64 oracle on the row's rows (tests/test_multiprocess.py
    :69, two processes of two devices there)."""
    c = dict(name="fwd", cfg="micro32", kind="forward", tables="uniform", mlp="uniform")
    cfg = JC.micro_test(batch_size=16)
    rng = np.random.default_rng(7)
    idx = np.stack([rng.integers(0, t.rows, 16) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.uniform(-1, 1, (16, cfg.dense_dim)).astype(np.float32)
    np.savez(tmp_path / "inputs.npz", **{"fwd/idx": idx, "fwd/dense": dense})
    res = spawn_world(4, run_cases, (2, 2, [c], str(tmp_path / "inputs.npz")), tmp_path)
    golden = jref.forward(cfg, jref.init_tables(cfg, scheme="uniform"),
                          jref.init_mlp_weights(cfg, scheme="uniform"), idx, dense)
    for r, rank in enumerate(res):
        d = r // 2
        np.testing.assert_allclose(rank["fwd"]["scores"], golden[d * 8:(d + 1) * 8],
                                   rtol=1e-4, atol=1e-3)


def test_two_row_sharded_serving_e2e(tmp_path):
    """`cli serve --mesh 2,2 --procs 4` as four OS processes: each data
    row's leader runs its own ingest tier and replies its rows' scores,
    its follower takes part in every forward; 3 batches, rowid tables,
    checked against the oracle (tests/test_multiprocess.py:88)."""
    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)

    outs = _serve_and_check(tmp_path, 2, 2, 8, 3, "rowid", "uniform", lambda x: x, close)
    import json

    for r, out in enumerate(outs):
        summary = json.loads(out.strip().splitlines()[-1])
        if r % 2:
            assert summary == {"role": "follower", "rank": r, "batches": 3}
        else:
            assert summary["batches"] == 3 and summary["wire_batches"] == 3


def test_four_row_fused_sharded_serving_e2e(tmp_path):
    """`cli serve --mesh 4,2 --procs 8 --fuse 4 --peer-timeout 120`: fused
    dispatch through forward_pipelined on every data row, each leader
    replying its 8 rows of the 32-row batch; pm1 tables, all-ones weights
    and +-1 dense keep every sum an integer: bit-exact against the oracle
    (tests/test_multiprocess.py:192)."""
    def exact(got, want):
        np.testing.assert_array_equal(got, want.astype(np.float32))

    outs = _serve_and_check(tmp_path, 4, 2, 8, 8, "pm1", "ones", np.sign, exact,
                            ("--fuse", "4", "--peer-timeout", "120"))
    import json

    for r, out in enumerate(outs):
        summary = json.loads(out.strip().splitlines()[-1])
        if r % 2 == 0:
            assert summary["wire_batches"] == 8 and summary["fuse"] == 4
        else:
            assert summary["batches"] == 2  # fused calls


def test_cli_serve_mesh_with_three_senders(tmp_path):
    """Twin of tests/test_multisender.py:200: `cli serve --mesh 2,2 --procs
    4 --senders 3`: each data row's leader binds three ports (the dense node
    and two slices of the tables) and replies its rows' scores on the first;
    pm1 tables, all-ones weights and dense of ones: bit-exact against the
    oracle; every leader's summary counts each batch from three senders."""
    def exact(got, want):
        np.testing.assert_array_equal(got, want.astype(np.float32))

    outs = _serve_and_check(tmp_path, 2, 2, 8, 4, "pm1", "ones", np.ones_like, exact,
                            senders=3)
    import json

    for r, out in enumerate(outs):
        summary = json.loads(out.strip().splitlines()[-1])
        if r % 2 == 0:
            assert summary["wire_batches"] == 4 and len(summary["per_sender"]) == 3
        else:
            assert summary == {"role": "follower", "rank": r, "batches": 4}


def test_init_distributed_binds_the_ranks_card_before_the_group(monkeypatch):
    """With a CUDA device, init_distributed makes the rank's card
    (LOCAL_RANK, else the rank, modulo the cards) the current device before
    it makes the process group, so NCCL's communicators sit on it; a CPU
    device binds nothing (a host without cards, patched to show four)."""
    import torch
    import torch.distributed as dist

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: calls.append(torch.device(d)))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw["rank"])))
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    init_distributed("localhost:29500", 4, 2, "nccl", device="cuda")
    assert calls == [torch.device("cuda", 2), ("nccl", 2)]
    calls.clear()
    monkeypatch.setenv("LOCAL_RANK", "1")
    init_distributed("localhost:29500", 8, 5, "gloo", device="cuda")
    assert calls == [torch.device("cuda", 1), ("gloo", 5)]
    calls.clear()
    init_distributed("localhost:29500", 2, 1, "gloo", device="cpu")
    assert calls == [("gloo", 1)]


def test_peer_stall_watchdog_aborts_instead_of_hanging(tmp_path):
    """A (1, 2) world whose follower is stopped (SIGSTOP) once both ranks are
    up: the leader's first dispatch waits in the exchange on a peer that
    never comes, and with --peer-timeout 5 the leader aborts with the
    watchdog's diagnostic and exit 124 instead of hanging
    (tests/test_multiprocess.py:293)."""
    deadline = time.monotonic() + 180
    procs, ports = _serve_world(tmp_path, 1, 2, 8, 1, ["--peer-timeout", "5"])
    try:
        _wait_banners(procs, 2, deadline)
        os.kill(procs[1].pid, signal.SIGSTOP)
        cfg = TC.micro_test(batch_size=8)
        rng = np.random.default_rng(3)
        idx = np.stack([rng.integers(0, t.rows, 8) for t in cfg.tables], 1).astype(np.int32)
        dense = rng.uniform(-1, 1, (8, cfg.dense_dim)).astype(np.float32)
        with socket.create_connection(("127.0.0.1", ports[0]), timeout=30) as sock:
            sock.sendall(idx.tobytes() + dense.tobytes())
            _, err = procs[0].communicate(timeout=90)
        assert procs[0].returncode == EXIT_PEER_TIMEOUT, (procs[0].returncode, err[-3000:])
        assert "peer-watchdog" in err, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# ---- PeerWatchdog (tests/test_compose.py:23, :32, :42) -------------------

def test_watchdog_fires_on_overrun():
    fired = []
    wd = PeerWatchdog(0.15, process_id=3, on_timeout=fired.append)
    with wd.guard("dispatch batch 7"):
        time.sleep(0.5)
    assert len(fired) == 1
    assert "process 3" in fired[0] and "dispatch batch 7" in fired[0]


def test_watchdog_quiet_when_guards_complete():
    fired = []
    wd = PeerWatchdog(0.3, on_timeout=fired.append)
    for i in range(3):
        with wd.guard(f"batch {i}"):
            time.sleep(0.02)
    time.sleep(0.5)  # past the timeout horizon with nothing armed
    assert not fired


def test_watchdog_overlapping_guards_earliest_deadline_wins():
    """The submit thread dispatches while the drain thread reads back: two
    live guards; the expiry of either fires."""
    fired = []
    wd = PeerWatchdog(0.2, on_timeout=fired.append)

    def long_readback():
        with wd.guard("readback batch 0"):
            time.sleep(0.6)

    th = threading.Thread(target=long_readback, daemon=True)
    th.start()
    time.sleep(0.05)
    with wd.guard("dispatch batch 1"):
        time.sleep(0.01)
    th.join(2)
    assert not th.is_alive()
    assert len(fired) == 1 and "readback batch 0" in fired[0]


# ---- build_engine and the CLI's refusals (tests/test_compose.py:63) --------

def test_build_engine_multiprocess_requires_mesh():
    model = init_model(TC.micro_test(batch_size=8), device=CPU)
    with pytest.raises(ValueError, match="requires a mesh"):
        build_engine(model, ServeSpec(batch=8, batches=1, multiprocess=True))


def test_build_engine_refuses_bags_on_a_mesh():
    model = init_model(TC.micro_test(batch_size=8), device=CPU)
    with pytest.raises(ValueError, match="single-device"):
        build_engine(model, ServeSpec(batch=8, batches=1, mesh=(1, 1), device=CPU, bag_L=4))


def test_one_rank_mesh_engine_scores_like_the_model():
    """serve's sharded engine on a (1, 1) mesh, one process and no process
    group: the engine's scores are the model's forward."""
    cfg = TC.micro_test(batch_size=8)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
    eng = build_engine(model, ServeSpec(batch=8, batches=1, mesh=(1, 1), device=CPU))
    rng = np.random.default_rng(2)
    idx = np.stack([rng.integers(0, t.rows, 8) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.uniform(-1, 1, (8, cfg.dense_dim)).astype(np.float32)
    got = {}
    eng.submit(idx, dense, on_done=lambda bid, s: got.__setitem__(bid, s))
    eng.drain()
    eng.close()
    import torch

    with torch.inference_mode():
        want = model(torch.from_numpy(idx), torch.from_numpy(dense)).numpy()
    np.testing.assert_allclose(got[0], want, rtol=2e-6, atol=1e-6)


def test_nccl_with_more_ranks_than_cards_names_gloo():
    """NCCL refuses two ranks on one card: asking for it with more ranks
    than cards (or on the CPU) raises before any rendezvous, naming
    --backend gloo."""
    with pytest.raises(ValueError, match="--backend gloo"):
        check_backend("nccl", "cuda", 2)
    with pytest.raises(ValueError, match="--backend gloo"):
        init_distributed("file:///nonexistent/rendezvous", 2, 0, "nccl", device="cpu")
    check_backend("gloo", "cpu", 8)


@pytest.mark.parametrize("argv", [
    ["--procs", "2"],                    # a world needs a mesh
    ["--mesh", "1,2"],                   # one device a rank: --procs 2
    ["--mesh", "2,2", "--procs", "2"],
])
def test_cli_serve_mesh_and_procs_must_agree(argv):
    with pytest.raises(SystemExit):
        cli.main(["serve", "--device", "cpu", "--config", "micro_test", *argv])
