"""The port's serving path (serving/engine.py, compose.py, ingest.py,
cli.py) end to end over loopback on the CPU, scores held against the
float64 oracle — twins of the loopback tests of test_compose.py and
test_multisender.py.  Ports 21380-21450 are used by no other test file
(xdist runs files in parallel)."""

import socket
import threading
import time

import numpy as np
import pytest

from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.cli import main
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.serving import (
    IndexWireFormat,
    IngestServer,
    ServeSpec,
    ServingEngine,
    build_engine,
    serve,
)

PORT = 21380


def _connect(port):
    for _ in range(200):
        try:
            return socket.create_connection(("127.0.0.1", port), timeout=10)
        except OSError:
            time.sleep(0.05)
    raise AssertionError(f"nothing listening on {port}")


def _recv(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return buf


def _batches(cfg, B, NB, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(NB):
        idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables],
                       1).astype(np.int32)
        dense = rng.uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)
        out.append((idx, dense))
    return out


def test_serve_library_end_to_end_loopback():
    """Twin of test_compose.py::test_serve_library_end_to_end_loopback:
    serve() as a library call with fuse=2 and a background drain, scores
    replied over loopback, against the oracle (rtol/atol 1e-4)."""
    B, NB = 8, 4
    cfg = C.get_config("micro_test", batch_size=B)
    tables = ref.init_tables(cfg, scheme="rowid")
    ws = ref.init_mlp_weights(cfg, scheme="uniform")
    model = init_model(cfg, tables_np=tables, mlp_np=ws)
    batches = _batches(cfg, B, NB, 5)
    spec = ServeSpec(batch=B, batches=NB, port=PORT, slots=4, reply=True,
                     fuse=2, bg_drain=True, warm=True)
    out = {}
    th = threading.Thread(target=lambda: out.update(summary=serve(cfg, model, spec)),
                          daemon=True)
    th.start()
    sock = _connect(PORT)
    with sock:
        for idx, dense in batches:
            sock.sendall(idx.tobytes() + dense.tobytes())
        buf = _recv(sock, NB * B * 4)
    th.join(60)
    assert not th.is_alive() and "summary" in out, "serve() did not finish"
    assert out["summary"]["wire_batches"] == NB
    assert out["summary"]["fuse"] == 2
    assert out["summary"]["batches"] == NB // 2
    scores = np.frombuffer(buf, np.float32).reshape(NB, B)
    for k, (idx, dense) in enumerate(batches):
        golden = ref.forward(cfg, tables, ws, idx, dense)
        np.testing.assert_allclose(scores[k], golden, rtol=1e-4, atol=1e-4)


def test_serve_multisender_pm1_exact():
    """Twin of test_multisender.py: the reference 3-node topology (dense
    node + two table-shard nodes) on pm1 / all-ones data, bit-exact."""
    B, NB = 8, 3
    cfg = C.get_config("micro_test", batch_size=B)
    tables = ref.init_tables(cfg, scheme="pm1")
    ws = ref.init_mlp_weights(cfg, scheme="ones")
    model = init_model(cfg, tables_np=tables, mlp_np=ws)
    wire = IndexWireFormat.plan(cfg, B, 3)
    batches = [(idx, np.ones((B, cfg.dense_dim), np.float32))
               for idx, _ in _batches(cfg, B, NB, 7)]
    port = PORT + 10
    spec = ServeSpec(batch=B, batches=NB, port=port, slots=4, senders=3,
                     reply=True)
    out = {}
    th = threading.Thread(target=lambda: out.update(summary=serve(cfg, model, spec)),
                          daemon=True)
    th.start()
    socks = [_connect(port + s) for s in range(3)]
    for idx, dense in batches:
        for s, payload in enumerate(wire.payloads(idx, dense)):
            socks[s].sendall(payload)
    buf = _recv(socks[0], NB * B * 4)
    for s in socks:
        s.close()
    th.join(60)
    assert not th.is_alive() and out["summary"]["wire_batches"] == NB
    assert len(out["summary"]["per_sender"]) == 3
    scores = np.frombuffer(buf, np.float32).reshape(NB, B)
    for k, (idx, dense) in enumerate(batches):
        golden = ref.forward(cfg, tables, ws, idx, dense).astype(np.float32)
        np.testing.assert_array_equal(scores[k], golden)


def test_serve_scatter_fans_scores_out():
    """serve() with a scatter consumer: every batch's scores reach it."""
    B, NB = 8, 2
    cfg = C.get_config("micro_test", batch_size=B)
    model = init_model(cfg)
    batches = [(idx, np.ones_like(d)) for idx, d in _batches(cfg, B, NB, 10)]
    got = []
    with socket.socket() as srv:
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", PORT + 50))
        srv.listen(1)

        def consume():
            conn, _ = srv.accept()
            with conn:
                conn.settimeout(30)
                got.append(_recv(conn, NB * B * 4))

        cons = threading.Thread(target=consume, daemon=True)
        cons.start()
        spec = ServeSpec(batch=B, batches=NB, port=PORT + 40, slots=4,
                         scatter=(f"127.0.0.1:{PORT + 50}",))
        out = {}
        th = threading.Thread(target=lambda: out.update(summary=serve(cfg, model, spec)),
                              daemon=True)
        th.start()
        with _connect(PORT + 40) as sock:
            for idx, dense in batches:
                sock.sendall(idx.tobytes() + dense.tobytes())
            th.join(60)
        cons.join(30)
    assert not th.is_alive() and not cons.is_alive()
    # the summary's counters are read while blocks may still be queued
    assert out["summary"]["scatter"]["dead"] == [False]
    tables = ref.init_tables(cfg, "pm1")
    ws = ref.init_mlp_weights(cfg, "ones")
    scores = np.frombuffer(got[0], np.float32).reshape(NB, B)
    for k, (idx, dense) in enumerate(batches):
        np.testing.assert_array_equal(
            scores[k], ref.forward(cfg, tables, ws, idx, dense).astype(np.float32))


def test_cli_serve_and_loadgen_loopback(capsys):
    """`cli serve --device cpu` against `cli loadgen --read-scores`."""
    port = PORT + 20
    common = ["--config", "micro_test", "--batch", "16"]
    th = threading.Thread(target=main, args=(
        ["serve", *common, "--device", "cpu", "--batches", "3", "--port", str(port),
         "--slots", "2", "--reply", "--bg-drain"],), daemon=True)
    th.start()
    main(["loadgen", *common, "--batches", "3", "--port", str(port), "--read-scores"])
    th.join(60)
    assert not th.is_alive()
    text = capsys.readouterr().out
    assert "scores received: 48" in text
    assert '"wire_batches": 3' in text


def test_engine_rejects_out_of_range_ids():
    cfg = C.get_config("micro_test", batch_size=4)
    eng = ServingEngine.from_model(init_model(cfg), batch_size=4)
    limits = [t.rows for t in cfg.tables]
    ok = np.zeros((4, cfg.num_tables), np.int32)
    eng.validate_indices(ok, limits)
    for bad_val in (-1, limits[2]):
        bad = ok.copy()
        bad[1, 2] = bad_val
        with pytest.raises(ValueError, match="batch row 1, table 2"):
            eng.validate_indices(bad, limits)


def test_engine_fuse_scores_equal_unfused():
    """fuse=K reshapes [K, B, T] to [K*B, T] for one forward: rows are
    independent, so on the integer-valued parity data the scores are the
    same bits."""
    cfg = C.get_config("micro_test", batch_size=4)
    model = init_model(cfg)
    (i0, d0), (i1, d1) = [(i, np.ones_like(d)) for i, d in _batches(cfg, 4, 2, 8)]
    one = ServingEngine.from_model(model, batch_size=4)
    two = ServingEngine.from_model(model, batch_size=4, fuse=2)
    fused = two.score_fn(np.stack([i0, i1]), np.stack([d0, d1])).numpy()
    assert fused.shape == (2, 4)
    np.testing.assert_array_equal(fused[0], one.score_fn(i0, d0).numpy())
    np.testing.assert_array_equal(fused[1], one.score_fn(i1, d1).numpy())


def test_latency_counts_time_in_the_ingest_ring():
    """A batch's latency runs from its first byte on the ingest tier's
    monotonic clock, so time the slot waited in the ring counts."""
    B = 4
    cfg = C.get_config("micro_test", batch_size=B)
    eng = ServingEngine.from_model(init_model(cfg), batch_size=B)
    (i0, d0), (i1, d1) = _batches(cfg, B, 2, 9)
    with IngestServer([B * (cfg.num_tables + cfg.dense_dim) * 4], n_slots=2,
                      port_base=PORT + 30) as ing:
        with _connect(PORT + 30) as sock:
            sock.sendall(i0.tobytes() + d0.tobytes() + i1.tobytes() + d1.tobytes())
            time.sleep(0.3)
            summary = eng.run_from_ingest(ing, 2, row_limits=[t.rows for t in cfg.tables])
    assert summary["batches"] == 2
    assert summary["latency_ms_p50"] >= 300.0


def test_build_engine_follows_the_spec():
    """build_engine gives a one-device engine shaped by the spec's batch,
    fuse and drain settings."""
    cfg = C.get_config("micro_test", batch_size=4)
    eng = build_engine(init_model(cfg), ServeSpec(batch=4, batches=2, fuse=2,
                                                  bg_drain=True))
    try:
        assert (eng.batch_size, eng.fuse) == (4, 2)
        assert eng.score_fn(*[np.stack([a, a]) for a in _batches(cfg, 4, 1, 3)[0]]).shape == (2, 4)
    finally:
        eng.close()
