"""The port's serving path (serving/engine.py, compose.py, ingest.py,
cli.py) end to end over loopback on the CPU, scores held against the
float64 oracle — twins of the loopback tests of test_compose.py and
test_multisender.py — and the engine's feature mode and servebench,
twins of test_ingest.py's.  Ports 21380-21480 are used by no other test
file (xdist runs files in parallel)."""

import socket
import threading
import time

import numpy as np
import pytest

from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.cli import main
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu.serving.servebench import _run_simulated as j_run_simulated
from fleetrec_tpu_torch.serving import (
    IndexWireFormat,
    IngestServer,
    Loadgen,
    ServeSpec,
    ServingEngine,
    build_engine,
    serve,
)
from fleetrec_tpu_torch.serving.servebench import _run_simulated, run_servebench

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


# ---- feature mode (ServingEngine.mlp_only) ----------------------------------

def test_engine_feature_mode_end_to_end():
    """Twin of test_ingest.py::test_engine_feature_mode_end_to_end: loadgen
    -> ingest -> mlp_only engine reproduces the closed-form all-ones
    score."""
    B, width = 16, 512
    cfg = C.parity_synthetic(width, batch_size=B)
    eng = ServingEngine.mlp_only(init_model(cfg), batch_size=B)
    outs = {}
    nbytes = B * width * 4
    with IngestServer([nbytes], n_slots=4, port_base=PORT + 60) as ing:
        Loadgen("127.0.0.1", PORT + 60, [nbytes], n_batches=6, fill=1.0).start()
        summary = eng.run_from_ingest(
            ing, 6, mode="feature", feature_dim=width,
            on_done=lambda bid, scores: outs.__setitem__(bid, scores))
    assert summary["batches"] == 6 and summary["latency_ms_p99"] > 0
    assert sorted(outs) == list(range(6))
    for scores in outs.values():
        np.testing.assert_array_equal(scores, np.full(B, 68719476736.0, np.float32))


def test_engine_feature_mode_three_sender_model3_wire():
    """Twin of test_ingest.py::test_engine_feature_mode_three_sender_model3_
    wire: 64 + 1952 + 1952 floats a query from three senders at fixed
    offsets, all-ones, scored to the closed form for width 3968."""
    B = 4
    widths = [64, 1952, 1952]
    F = sum(widths)
    cfg = C.parity_synthetic(F, batch_size=B)
    eng = ServingEngine.mlp_only(init_model(cfg), batch_size=B)
    nbytes = [B * w * 4 for w in widths]
    outs = {}
    with IngestServer(nbytes, n_slots=2, port_base=PORT + 70) as ing:
        Loadgen("127.0.0.1", PORT + 70, nbytes, n_batches=3, fill=1.0).start()
        summary = eng.run_from_ingest(
            ing, 3, mode="feature", feature_dim=F,
            on_done=lambda bid, s: outs.__setitem__(bid, s))
    assert summary["batches"] == 3 and len(outs) == 3
    want = ref.closed_form_all_ones_score(F)
    for scores in outs.values():
        np.testing.assert_array_equal(scores, np.full(B, want, np.float32))


def test_feature_mode_refuses_fuse_and_warmup():
    cfg = C.parity_synthetic(512, batch_size=4)
    eng = ServingEngine.mlp_only(init_model(cfg), batch_size=4)
    with pytest.raises(ValueError, match="index-mode"):
        eng.warmup()
    eng.fuse = 2
    with pytest.raises(ValueError, match="index-mode only"):
        eng.run_from_ingest(None, 2, mode="feature", feature_dim=512)
    eng.fuse = 1
    with pytest.raises(ValueError, match="feature_dim"):
        eng.run_from_ingest(None, 2, mode="feature")
    with pytest.raises(ValueError, match="mode"):
        eng.run_from_ingest(None, 2, mode="bags")


def test_mlp_only_scores_the_tower_of_a_table_model():
    """Feature mode runs the model's MLP tower alone: its scores on a
    feature batch equal the float64 oracle's chain within rtol 1e-5 (fp32
    sums)."""
    cfg = C.get_config("micro_test", batch_size=8)
    model = init_model(cfg, mlp_scheme="uniform")
    eng = ServingEngine.mlp_only(model, batch_size=8)
    x = np.random.default_rng(4).uniform(-1, 1, (8, cfg.feature_dim)).astype(np.float32)
    want = ref.mlp_chain(x.astype(np.float64), ref.init_mlp_weights(cfg, "uniform"))
    np.testing.assert_allclose(eng.score_fn(x, None).numpy(), want[:, 0],
                               rtol=1e-5, atol=1e-6)


# ---- servebench ---------------------------------------------------------------

@pytest.mark.parametrize("qps,fuse,max_in_flight,service_ms", [
    (1000, 1, 2, 0.5), (50_000, 4, 1, 3.0), (200_000, 1, 3, 0.7), (20_000, 2, 2, 12.0),
])
def test_simulated_servebench_equals_jax(qps, fuse, max_in_flight, service_ms):
    """The event-driven recurrence, field by field against the JAX
    package's on the same seeded arrivals (exact: the same numpy code)."""
    kw = dict(batch_size=64, offered_qps=qps, duration_s=1.0, max_wait_ms=2.0,
              max_in_flight=max_in_flight, fuse=fuse, service_ms=service_ms)
    got = _run_simulated(rng=np.random.default_rng(3), **kw).to_json()
    want = j_run_simulated(rng=np.random.default_rng(3), **kw).to_json()
    assert got == want
    assert run_servebench(None, 64, qps, duration_s=1.0, seed=3,
                          max_in_flight=max_in_flight, fuse=fuse,
                          simulate_service_ms=service_ms).to_json() == want


def test_servebench_device_pool_and_fuse():
    """Twin of test_ingest.py::test_servebench_device_pool_and_fuse."""
    cfg = C.get_config("micro_test", batch_size=16)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform")
    for kw in ({"device_pool": True}, {"fuse": 4}):
        r = run_servebench(model, batch_size=16, offered_qps=4000,
                           duration_s=0.5, max_wait_ms=2.0, **kw)
        assert r.n_queries > 500
        assert r.achieved_qps > 1000
        assert r.latency_ms_p99 < 5000


def test_servebench_reads_each_dispatch_back_when_it_completes():
    """At low load a dispatch is read back once its forward is done, not
    after max_in_flight later dispatches (the JAX loop's deferral, which
    adds two 5 ms batch-formation windows to its service time here)."""
    cfg = C.get_config("micro_test", batch_size=32)
    r = run_servebench(init_model(cfg), batch_size=32, offered_qps=500,
                       duration_s=1.0, max_wait_ms=5.0, max_in_flight=2)
    assert r.n_dispatches > 50
    assert r.service_ms_p50 < 5.0
    assert r.latency_ms_p50 < r.wait_ms_p50 + 5.0


def test_servebench_cpu_smoke():
    """Twin of test_ingest.py::test_servebench_cpu_smoke."""
    cfg = C.get_config("micro_test", batch_size=32)
    r = run_servebench(init_model(cfg), batch_size=32, offered_qps=1000,
                       duration_s=1.0, max_wait_ms=2.0)
    assert r.n_queries > 500
    assert 0.5 * r.offered_qps < r.achieved_qps < 2 * r.offered_qps
    assert 0 < r.latency_ms_p50 <= r.latency_ms_p99 <= r.latency_ms_max
