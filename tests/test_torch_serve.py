"""The port's serving path (serving/engine.py, compose.py, ingest.py,
cli.py) end to end over loopback on the CPU, scores held against the
float64 oracle — twins of the loopback tests of test_compose.py and
test_multisender.py — and the engine's feature mode and servebench,
twins of test_ingest.py's.  Ports 21380-21480 are used by no other test
file (xdist runs files in parallel).  The ScatterEgress tests at the end are
twins of tests/test_scatter.py's (slow, dead, restarted and reattached
consumers, 11-way fan-out) and the QR test a twin of
tests/test_qr.py::test_qr_serving_engine_end_to_end; each of those runs
under its own time limit (``within``) on ports the system hands out."""

import dataclasses
import functools
import socket
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.cli import main
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu.serving.servebench import _run_simulated as j_run_simulated
from fleetrec_tpu_torch.serving import (
    IndexWireFormat,
    IngestServer,
    Loadgen,
    ScatterEgress,
    ServeSpec,
    ServingEngine,
    build_engine,
    serve,
)
from fleetrec_tpu_torch.serving.servebench import _run_simulated, run_servebench
from torch_variants import CPU

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
    model = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)
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
    model = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)
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
    model = init_model(cfg, device=CPU)
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
    eng = ServingEngine.from_model(init_model(cfg, device=CPU), batch_size=4)
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
    model = init_model(cfg, device=CPU)
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
    eng = ServingEngine.from_model(init_model(cfg, device=CPU), batch_size=B)
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
    eng = build_engine(init_model(cfg, device=CPU), ServeSpec(batch=4, batches=2, fuse=2,
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
    eng = ServingEngine.mlp_only(init_model(cfg, device=CPU), batch_size=B)
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
    eng = ServingEngine.mlp_only(init_model(cfg, device=CPU), batch_size=B)
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
    eng = ServingEngine.mlp_only(init_model(cfg, device=CPU), batch_size=4)
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
    model = init_model(cfg, mlp_scheme="uniform", device=CPU)
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
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=CPU)
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
    r = run_servebench(init_model(cfg, device=CPU), batch_size=32, offered_qps=500,
                       duration_s=1.0, max_wait_ms=5.0, max_in_flight=2)
    assert r.n_dispatches > 50
    assert r.service_ms_p50 < 5.0
    assert r.latency_ms_p50 < r.wait_ms_p50 + 5.0


def test_servebench_cpu_smoke():
    """Twin of test_ingest.py::test_servebench_cpu_smoke."""
    cfg = C.get_config("micro_test", batch_size=32)
    r = run_servebench(init_model(cfg, device=CPU), batch_size=32, offered_qps=1000,
                       duration_s=1.0, max_wait_ms=2.0)
    assert r.n_queries > 500
    assert 0.5 * r.offered_qps < r.achieved_qps < 2 * r.offered_qps
    assert 0 < r.latency_ms_p50 <= r.latency_ms_p99 <= r.latency_ms_max


# -- ScatterEgress: twins of tests/test_scatter.py ----------------------------

def within(seconds):
    """Run the test in a daemon thread and fail it after ``seconds``: a
    socket that never answers fails one test instead of hanging the run."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            box = {}

            def body():
                try:
                    fn(*args, **kw)
                except BaseException as e:  # noqa: BLE001 (re-raised below)
                    box["error"] = e

            th = threading.Thread(target=body, daemon=True)
            th.start()
            th.join(seconds)
            assert not th.is_alive(), f"{fn.__name__} still running after {seconds} s"
            if "error" in box:
                raise box["error"]
        return run
    return deco


def _free_ports(n):
    """n distinct ports the system just handed out (each bound once, then
    released; the consumers rebind them with SO_REUSEADDR)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class _Consumer(threading.Thread):
    """Listening consumer: accepts one producer connection and drains fixed
    blocks.  paused=True reads nothing until ``resume`` is set; with a small
    receive buffer that defeats kernel socket buffering, so the producer
    sees backpressure."""

    def __init__(self, port, block_bytes, paused=False):
        super().__init__(daemon=True)
        self.block_bytes = block_bytes
        self.blocks = []
        self.resume = threading.Event()
        if not paused:
            self.resume.set()
        self.srv = socket.socket()
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        if paused:
            # inherited by the accepted socket: caps what the kernel absorbs
            self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 16)
        self.srv.bind(("127.0.0.1", port))
        self.srv.listen(1)
        self.srv.settimeout(30)
        self.stop = False

    def run(self):
        try:
            conn, _ = self.srv.accept()
        except OSError:
            self.srv.close()
            return
        conn.settimeout(0.2)
        self.resume.wait()
        buf = b""
        while not self.stop:
            try:
                chunk = conn.recv(1 << 16)
            except socket.timeout:
                continue
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            while len(buf) >= self.block_bytes:
                self.blocks.append(np.frombuffer(buf[: self.block_bytes], np.float32))
                buf = buf[self.block_bytes:]
        conn.close()
        self.srv.close()


def _wait(cond, seconds):
    deadline = time.time() + seconds
    while time.time() < deadline and not cond():
        time.sleep(0.05)


@within(60)
def test_scatter_slow_consumer_isolated():
    """A consumer that reads nothing must not stall the others: its bounded
    queue fills, the round-robin skips it, and the fast pair carries the
    rest while the producer never blocks."""
    B = 1 << 18  # 1 MiB blocks defeat socket buffering
    ports = _free_ports(3)
    fast = [_Consumer(ports[0], B * 4), _Consumer(ports[1], B * 4)]
    slow = _Consumer(ports[2], B * 4, paused=True)
    for c in fast + [slow]:
        c.start()
    NBLK = 30
    with ScatterEgress(queue_blocks=2) as eg:
        for p in ports:
            eg.connect("127.0.0.1", p)
        t0 = time.time()
        for i in range(NBLK):
            eg.send(np.full(B, float(i), np.float32))
        send_time = time.time() - t0
        stats = eg.stats()
        slow.resume.set()  # so that close() can drain its queue
    _wait(lambda: sum(len(c.blocks) for c in fast + [slow]) >= NBLK, 10)
    for c in fast + [slow]:
        c.stop = True
    assert send_time < 10.0, f"producer stalled behind the slow consumer: {send_time:.1f}s"
    assert stats["skipped"] > 0  # the isolation engaged
    got = [len(c.blocks) for c in fast + [slow]]
    assert sum(got) == NBLK  # nothing lost
    # the stalled consumer absorbs at most its queue (2), a block in flight
    # and a couple of MiB of kernel buffers before every further block skips
    assert got[2] <= 10, f"the stalled consumer absorbed too much: {got}"
    assert got[0] + got[1] >= NBLK - 10


@within(60)
def test_scatter_dead_consumer_skipped():
    """A consumer whose connection dies is skipped; the stream continues to
    the survivor, and send() never raises."""
    B = 32
    ports = _free_ports(2)
    c0, c1 = _Consumer(ports[0], B * 4), _Consumer(ports[1], B * 4)
    c0.start()
    c1.start()
    with ScatterEgress(queue_blocks=1) as eg:
        for p in ports:
            eg.connect("127.0.0.1", p)
        eg.send(np.zeros(B, np.float32))
        eg.send(np.zeros(B, np.float32))
        c0.stop = True
        c0.join(5)
        time.sleep(0.3)
        for _ in range(10):
            eg.send(np.ones(B, np.float32))
            time.sleep(0.02)  # let the sender thread hit the reset
        stats = eg.stats()
    # TCP can absorb a block or two before the reset surfaces
    assert stats["per_consumer_blocks"][1] >= 8, stats
    c1.stop = True


@within(60)
def test_scatter_consumer_reconnect_mid_stream():
    """Kill a consumer mid-stream and restart it on the same port: the
    sender thread redials in-band and delivery resumes, whole blocks only."""
    B = 64
    (port,) = _free_ports(1)
    first = _Consumer(port, B * 4)
    first.start()
    with ScatterEgress(queue_blocks=4) as eg:
        eg.connect("127.0.0.1", port)
        for i in range(5):
            eg.send(np.full(B, float(i), np.float32))
        _wait(lambda: len(first.blocks) >= 5, 5)
        assert len(first.blocks) == 5
        first.stop = True
        first.join(5)
        second = _Consumer(port, B * 4)
        second.start()
        for i in range(5, 15):
            eg.send(np.full(B, float(i), np.float32))
            time.sleep(0.05)  # let the sender thread hit the reset and redial
        # blocks flushed into the dead socket before the reset surfaced are
        # lost, as with any TCP peer crash; what follows the redial arrives
        _wait(lambda: len(second.blocks) >= 8, 10)
        stats = eg.stats()
    second.stop = True
    assert stats["reconnects"][0] >= 1, stats
    assert not stats["dead"][0], stats
    assert len(second.blocks) >= 8, len(second.blocks)
    assert sorted(int(b[0]) for b in second.blocks)[-1] == 14  # resumed to the end
    for b in second.blocks:
        assert np.all(b == b[0])  # no torn block


@within(90)
def test_scatter_dead_consumer_reattach():
    """An outage longer than the redial window marks the consumer dead;
    reattach revives it once the destination is back."""
    B = 32
    (port,) = _free_ports(1)
    c0 = _Consumer(port, B * 4)
    c0.start()
    with ScatterEgress(queue_blocks=2) as eg:
        eg.connect("127.0.0.1", port)
        eg.send(np.zeros(B, np.float32))
        c0.stop = True
        c0.join(5)
        # the sender thread notices on its next send, then redials for ~5 s
        deadline = time.time() + 20
        while time.time() < deadline and not eg.stats()["dead"][0]:
            try:
                eg.send(np.zeros(B, np.float32))
            except OSError:  # no live consumer remains
                pass
            time.sleep(0.1)
        assert eg.stats()["dead"][0]
        with pytest.raises(OSError):
            eg.reattach(0)  # the destination is still down: stays dead
        c1 = _Consumer(port, B * 4)
        c1.start()
        eg.reattach(0)
        assert not eg.stats()["dead"][0]
        for i in range(3):
            eg.send(np.full(B, float(i), np.float32))
        _wait(lambda: len(c1.blocks) >= 3, 5)
    c1.stop = True
    assert len(c1.blocks) >= 3


@within(120)
def test_scatter_eleven_consumer_fanout_with_slow_and_killed():
    """The reference's 11-way fan-out with one consumer that reads nothing
    and one killed mid-stream: the 9 healthy ones carry the load, the slow
    one sheds only its own share, the dead one is marked dead and skipped,
    and the producer never stalls."""
    B = 1 << 18
    N, SLOW, DEAD, NBLK = 11, 9, 10, 110
    ports = _free_ports(N)
    consumers = [_Consumer(ports[c], B * 4, paused=(c == SLOW)) for c in range(N)]
    for c in consumers:
        c.start()
    with ScatterEgress(queue_blocks=2) as eg:
        for p in ports:
            eg.connect("127.0.0.1", p)
        t0 = time.time()
        for i in range(NBLK):
            eg.send(np.full(B, float(i), np.float32))
            if i == 22:
                consumers[DEAD].stop = True
                consumers[DEAD].join(5)
                time.sleep(0.2)  # let the reset surface at the producer
        send_time = time.time() - t0
        # the killed consumer's sender redials its closed port for ~5 s
        _wait(lambda: eg.stats()["dead"][DEAD], 20)
        stats = eg.stats()
        consumers[SLOW].resume.set()
    _wait(lambda: sum(len(c.blocks) for c in consumers) >= NBLK - 5, 15)
    for c in consumers:
        c.stop = True
    got = [len(c.blocks) for c in consumers]
    assert send_time < 20.0, f"producer stalled: {send_time:.1f}s"
    assert stats["dead"][DEAD] and sum(stats["dead"]) == 1, stats
    assert stats["skipped"] > 0, stats
    assert got[SLOW] <= 8, f"the slow consumer absorbed too much: {got}"
    assert got[DEAD] <= 22 // N + 3, got
    healthy = sum(got[c] for c in range(N) if c not in (SLOW, DEAD))
    assert healthy >= NBLK - got[SLOW] - got[DEAD] - stats["skipped"], (got, stats)
    assert healthy >= NBLK * 0.7, (got, stats)
    for c in consumers:
        for blk in c.blocks:
            assert np.all(blk == blk[0])


@within(60)
def test_qr_serving_engine_end_to_end():
    """A QR config through the TCP serving tier (3-sender index mode): the
    wire carries config-order ids (the QR expansion is inside the forward);
    the engine's scores equal the port's direct forward and, bit for bit on
    pm1 / all-ones data, the JAX package's jitted QR forward."""
    def qr_cfg(mod):
        cfg = dataclasses.replace(mod.micro_test(batch_size=8), qr_threshold=100, qr_rem=16)
        cfg.validate()
        return cfg

    cfg = qr_cfg(C)
    B, NB = 8, 4
    model = init_model(cfg, table_scheme="pm1", mlp_scheme="ones", device=CPU)
    assert model.plan.qr_positions
    eng = ServingEngine.from_model(model, batch_size=B)
    wire = IndexWireFormat.plan(cfg, B, 3)
    batches = [(idx, np.sign(d).astype(np.float32)) for idx, d in _batches(cfg, B, NB, 6)]
    streams = [b"" for _ in range(3)]
    for idx, dense in batches:
        for s, p in enumerate(wire.payloads(idx, dense)):
            streams[s] += p
    outs = {}
    for _ in range(20):  # three consecutive free ports
        (port,) = _free_ports(1)
        try:
            ing = IngestServer(wire.bytes_per_sender(), n_slots=4, port_base=port)
            break
        except OSError:
            continue
    else:
        raise AssertionError("no three consecutive free ports")
    with ing:
        def send(s):
            with socket.create_connection(("127.0.0.1", port + s), timeout=5) as sock:
                sock.sendall(streams[s])

        ths = [threading.Thread(target=send, args=(s,), daemon=True) for s in range(3)]
        for t in ths:
            t.start()
        summary = eng.run_from_ingest(
            ing, NB, mode="index", wire=wire, timeout_ms=10_000,
            row_limits=[t.rows for t in cfg.tables],
            on_done=lambda bid, sc: outs.__setitem__(bid, sc))
        for t in ths:
            t.join(5)
    assert summary["batches"] == NB
    jmodel, jparams = j_init_model(qr_cfg(JC), table_scheme="pm1", mlp_scheme="ones")
    jforward = jax.jit(jmodel.forward)
    for b, (idx, dense) in enumerate(batches):
        with torch.no_grad():
            direct = model(torch.from_numpy(idx), torch.from_numpy(dense)).numpy()
        np.testing.assert_array_equal(outs[b], direct)
        want = np.asarray(jforward(jparams, jnp.asarray(idx), jnp.asarray(dense)))
        np.testing.assert_array_equal(outs[b], want)
