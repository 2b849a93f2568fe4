"""The serving engine's per-batch spans (``serving/engine.py``: the stamps
of ``BatchRecord``, ``SPANS``) on the CPU, served through the native ingest
tier at a tiny size, and the benchmark's reading of them
(``portbench/spans.py``): the seven span readers on hand-made outcomes, the
profiler's clock mapped onto the monotonic one, the device's idle gaps put
down to spans, and the records widened without moving the two metrics that
read their first three columns.  Besides, a CPU engine scores every batch
eagerly (no CUDA graph), and says so in its counters and records; the
graph slots' choice of batches, which needs no card, is checked here too
(the replays themselves in tests/test_torch_engine_graph.py, on the card)."""

import dataclasses
import socket
import threading
import time

import numpy as np
import pytest
import torch

from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.parallel import ShardedFleetRec, make_mesh
from fleetrec_tpu_torch.serving import IngestServer, ServingEngine
from fleetrec_tpu_torch.serving.engine import SPANS, BatchRecord, GraphSlots
from portbench import loader, spans
from portbench.serve import Cell, Outcome
from torch_variants import CPU

B, NB = 4, 6
# a batch's stamps in the order it crosses them (acquire's own start, the
# loop's last stamp before it, is checked apart)
CHAIN = ("t_first_byte_ns", "t_complete_ns", "t_acquired_ns", "t_parsed_ns", "t_validated_ns",
         "t_submit_ns", "t_h2d_ns", "t_dispatched_ns", "t_dequeued_ns", "t_done_ns",
         "t_replied_ns")
SPAN = {n: (a, b) for n, _w, a, b in SPANS}


def _open_ingest(nbytes, slots):
    rng = np.random.default_rng()
    for _ in range(20):
        base = int(rng.integers(30000, 60000))
        try:
            return IngestServer(nbytes, n_slots=slots, port_base=base)
        except OSError:
            continue
    raise OSError("no free ingest port")


def _span(rec, name):
    a, b = SPAN[name]
    return getattr(rec, b) - getattr(rec, a)


def _served(fuse, bg):
    """NB batches of micro_test served through an IngestServer with
    replies to the one sender: (engine, records in batch order, batches,
    replied scores [NB, B], run_from_ingest's summary)."""
    cfg = C.get_config("micro_test", batch_size=B)
    eng = ServingEngine.from_model(init_model(cfg, device=CPU), batch_size=B,
                                   background_drain=bg, fuse=fuse)
    rng = np.random.default_rng(7)
    batches = [(np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32),
                rng.uniform(-1, 1, (B, cfg.dense_dim)).astype(np.float32)) for _ in range(NB)]
    got = {}
    with _open_ingest([B * (cfg.num_tables + cfg.dense_dim) * 4], 4) as ing:
        def send():
            with socket.create_connection(("127.0.0.1", ing.port_base), timeout=30) as s:
                for i, d in batches:
                    s.sendall(i.tobytes() + d.tobytes())
                buf = b""
                while len(buf) < NB * B * 4:
                    chunk = s.recv(NB * B * 4 - len(buf))
                    if not chunk:
                        break
                    buf += chunk
                got["scores"] = np.frombuffer(buf, np.float32).reshape(-1, B)

        th = threading.Thread(target=send, daemon=True)
        th.start()
        try:
            got["summary"] = eng.run_from_ingest(ing, NB, row_limits=[t.rows for t in cfg.tables],
                                                 reply_to=0)
        finally:
            eng.close()
        th.join(30)
    recs = sorted(eng.stats.records, key=lambda r: r.batch_id)
    return eng, recs, batches, got["scores"], got["summary"]


@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("bg", [False, True], ids=["inline_drain", "background_drain"])
def test_served_spans_are_ordered_tile_the_loop_and_sum_to_the_latency(fuse, bg):
    eng, recs, batches, scores, _summary = _served(fuse, bg)
    assert len(recs) == NB // fuse and scores.shape == (NB, B)
    for k, (i, d) in enumerate(batches):
        np.testing.assert_allclose(scores[k], eng.score_fn(i, d).numpy(), rtol=1e-5, atol=1e-6)
    for r in recs:
        chain = [getattr(r, c) for c in CHAIN]
        assert all(chain) and chain == sorted(chain), (r, chain)
        assert 0 < r.t_acquire_call_ns <= r.t_acquired_ns
        # first byte -> submit and submit -> done are exactly their spans
        assert r.t_submit_ns - r.t_first_byte_ns == sum(
            _span(r, n) for n in ("wire", "ring_wait", "parse", "validate", "slot_wait"))
        assert r.t_done_ns - r.t_submit_ns == sum(
            _span(r, n) for n in ("h2d", "dispatch", "queued", "readback"))
        assert r.latency_ns == r.t_done_ns - r.t_first_byte_ns
    # the loop thread's time, from the first acquire to the last dispatch,
    # tiled with no gap and no overlap: the loop spans of every batch and,
    # draining inline, the readbacks and replies the loop drained
    loop = [(r.t_acquire_call_ns, r.t_dispatched_ns) for r in recs]
    marks = {r.t_dispatched_ns for r in recs} | {r.t_replied_ns for r in recs}
    inline = [(r.t_dequeued_ns, r.t_replied_ns) for r in recs if r.t_dequeued_ns in marks]
    assert bool(inline) == (not bg and NB // fuse > eng.max_in_flight)
    tiles = sorted(loop + inline)
    assert all(a < b for a, b in tiles)
    assert all(tiles[k + 1][0] == tiles[k][1] for k in range(len(tiles) - 1)), tiles
    assert tiles[0][0] == recs[0].t_acquire_call_ns
    assert tiles[-1][1] >= recs[-1].t_dispatched_ns


@pytest.mark.parametrize("fuse", [1, 2])
@pytest.mark.parametrize("bg", [False, True], ids=["inline_drain", "background_drain"])
def test_a_cpu_engine_scores_every_batch_eagerly(fuse, bg):
    eng, recs, batches, scores, summary = _served(fuse, bg)
    assert eng._graphs is None
    assert summary["eager_forwards"] == eng.eager_forwards == NB // fuse
    assert summary["graph_replays"] == eng.graph_replays == 0
    assert summary["graph_capture_s"] == 0.0
    assert [r.graph for r in recs] == [False] * (NB // fuse)
    want = np.concatenate([eng.score_fn(i, d).numpy() for i, d in batches])
    np.testing.assert_array_equal(scores.reshape(-1), want)


def test_graph_slots_take_batches_of_the_served_shape_in_turn():
    """``GraphSlots.copy_in``: a batch of the served shape (int32 ids,
    float32 dense) goes into slot k % n; another shape, int64 ids or a
    missing dense goes to the eager copy, and ``forward`` scores those
    eagerly."""
    cfg = C.get_config("micro_test", batch_size=B)
    eng = ServingEngine.from_model(init_model(cfg, device=CPU), batch_size=B)
    ids_shape, dense_shape = eng._served_shapes()
    assert ids_shape == (B, cfg.num_tables) and dense_shape == (B, cfg.dense_dim)
    g = GraphSlots(eng.copy_in, eng.forward, ids_shape, dense_shape, 3, torch.device("cpu"))
    rng = np.random.default_rng(4)

    def batch(rows=B):
        return (np.stack([rng.integers(0, t.rows, rows) for t in cfg.tables], 1).astype(np.int32),
                rng.uniform(-1, 1, (rows, cfg.dense_dim)).astype(np.float32))

    taken = []
    for _ in range(7):
        i, d = batch()
        ops = g.copy_in(i, d)
        np.testing.assert_array_equal(ops[0].numpy(), i)
        taken.append(next(k for k, s in enumerate(g.slots) if s.ids is ops[0] and s.dense is ops[1]))
    assert taken == [0, 1, 2, 0, 1, 2, 0]
    i, d = batch()
    assert not g.fits(i, None) and g.copy_in(i, None)[1] is None
    for other in [batch(B // 2), (i.astype(np.int64), d), (i, d.astype(np.float64))]:
        ops = g.copy_in(*other)
        assert all(ops[0] is not s.ids for s in g.slots)
        np.testing.assert_array_equal(g.forward(*ops).numpy(), eng.score_fn(*other).numpy())
        assert not g.replayed
    assert g._batches == 7


def test_a_batch_submitted_directly_has_no_ring_stamps():
    cfg = C.get_config("micro_test", batch_size=B)
    eng = ServingEngine.from_model(init_model(cfg, device=CPU), batch_size=B)
    idx = np.zeros((B, cfg.num_tables), np.int32)
    eng.submit(idx, np.zeros((B, cfg.dense_dim), np.float32))
    eng.drain()
    (r,) = eng.stats.records
    assert r.t_first_byte_ns == r.t_complete_ns == r.t_acquired_ns == r.t_parsed_ns == 0
    chain = [getattr(r, c) for c in CHAIN[5:]]
    assert all(chain) and chain == sorted(chain)
    assert r.latency_ns == r.t_done_ns - r.t_submit_ns


def _engine(kind):
    cfg = C.get_config("micro_test", batch_size=B)
    model = init_model(cfg, device=CPU)
    if kind == "from_model":
        return ServingEngine.from_model(model, batch_size=B), (B, cfg.num_tables), cfg.dense_dim
    if kind == "from_sharded":
        sharded = ShardedFleetRec(model, make_mesh(1, 1, CPU))
        return ServingEngine.from_sharded(sharded, batch_size=B), (B, cfg.num_tables), cfg.dense_dim
    return ServingEngine.mlp_only(model, batch_size=B), (B, cfg.feature_dim), 0


@pytest.mark.parametrize("kind", ["from_model", "from_sharded", "mlp_only"])
def test_copy_in_puts_the_operands_on_the_device_and_forward_scores_them(kind):
    eng, shape, dense_dim = _engine(kind)
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 4, shape).astype(np.int32) if kind != "mlp_only"
         else rng.uniform(-1, 1, shape).astype(np.float32))
    d = rng.uniform(-1, 1, (B, dense_dim)).astype(np.float32) if dense_dim else None
    ops = eng.copy_in(x, d)
    assert all(o is None or isinstance(o, torch.Tensor) for o in ops)
    np.testing.assert_array_equal(ops[0].numpy(), x)
    np.testing.assert_array_equal(eng.forward(*ops).numpy(), eng.score_fn(x, d).numpy())


# -- the benchmark's reading of the spans ----------------------------------

T0 = 10_000_000_000  # the window opens here (monotonic ns)
MS = 1_000_000


def _rec(k, t):
    """Batch k's stamps from t: wire 1 ms, ring_wait 5, parse 0.2, validate
    0.3, slot_wait 0.1, h2d 0.4, dispatch 0.5, queued 0.1, readback 0.6,
    reply 0.05 (ms); the loop asks for the slot 1 ms before it has it.  A
    batch every 2.5 ms: one batch's acquire starts at the dispatch end of the
    batch before."""
    steps = (("t_first_byte_ns", 0), ("t_complete_ns", 1.0), ("t_acquired_ns", 5.0),
             ("t_parsed_ns", 0.2), ("t_validated_ns", 0.3), ("t_submit_ns", 0.1),
             ("t_h2d_ns", 0.4), ("t_dispatched_ns", 0.5), ("t_dequeued_ns", 0.1),
             ("t_done_ns", 0.6), ("t_replied_ns", 0.05))
    st = {}
    for name, dt in steps:
        t += int(dt * MS)
        st[name] = t
    st["t_acquire_call_ns"] = st["t_acquired_ns"] - MS
    return BatchRecord(k, st.pop("t_first_byte_ns"), st.pop("t_submit_ns"), **st)


def _outcome(n=4, trace=None, pitch=int(2.5 * MS), columns=None):
    recs = [_rec(k, T0 + k * pitch) for k in range(n)]
    eng = type("E", (), {"stats": type("S", (), {"records": recs})()})()
    records = spans.records_of(eng)
    if columns is not None:
        records = records[:, :columns]
    cell = Cell("c", "c", 1, {}, {"batch": B}, {}, {})
    recv = np.asarray([r.t_replied_ns for r in recs], np.int64)
    head = {"t_open_ns": T0, "t_close_ns": T0 + 1000 * MS, "warm": 0, "n_sent": n}
    return Outcome(cell, 1.0, head, recv, np.zeros((n, B), np.float32), records, 0.0, 0,
                   trace, [])


def _trace(gaps, readbacks, offset=5 * 10**17):
    """A trace on a clock ``offset`` ns ahead of the monotonic one, whose
    device is idle in ``gaps`` (monotonic ns) and copies ``readbacks``
    score batches back."""
    ops = [("Memcpy DtoH (Device -> Pinned)", T0 + 900 * MS + k, T0 + 900 * MS + k + 1)
           for k in range(readbacks)]
    g = [(a + offset, b + offset) for a, b in gaps]
    clock = spans.Clock([(T0, T0 + offset, 100, 0), (T0 + 10**9, T0 + 10**9 + offset, 100, 0)])
    return spans.SpanTrace(ops, [], T0 + offset, T0 + 10**9 + offset, 0, g, clock=clock)


# each reader's value on four batches of _rec, all in the window of 1 s;
# idle_host: gaps of 0.1 ms in batch 0's parse and batch 1's h2d, one of 0.3
# ms in batch 2's acquire (not host work), over 2 readbacks
READ = {
    "ring_wait_ms.stream": 5.0, "parse_ms.stream": 0.2, "validate_ms.stream": 0.3,
    "h2d_ms.stream": 0.4, "dispatch_ms.stream": 0.5,
    "loop_busy.stream": 100.0 * 4 * (0.2 + 0.3 + 0.4 + 0.5) * MS / 1e9,
    "idle_host_ms.stream": 0.2 / 2,
}


def _gaps():
    acq = [T0 + int(2.5 * k * MS) + 6 * MS for k in range(4)]  # each batch's t_acquired_ns
    return [(acq[0] + int(0.05 * MS), acq[0] + int(0.15 * MS)),  # parse
            (acq[1] + int(0.65 * MS), acq[1] + int(0.75 * MS)),  # h2d
            (acq[2] - int(0.6 * MS), acq[2] - int(0.3 * MS))]    # acquire; batch 1's readback


@pytest.mark.parametrize("name", sorted(READ))
def test_span_readers_on_known_stamps(name):
    read = spans.READERS[name]
    out = _outcome(trace=_trace(_gaps(), 2))
    assert read(out) == pytest.approx(READ[name], rel=1e-9)
    # nothing to read: the program's records without the spans' columns
    assert read(_outcome(trace=_trace(_gaps(), 2), columns=3)) is None
    if name == "idle_host_ms.stream":
        assert read(_outcome(trace=None)) is None
        assert read(_outcome(trace=_trace(_gaps(), 0))) is None


def test_idle_by_span_keys_each_gap_by_both_threads():
    tr = _trace(_gaps() + [(T0 + 500 * MS, T0 + 501 * MS)], 2)
    got = spans.idle_by_span(tr, _outcome().records)
    assert [k for k, _v in got] == ["loop: none / drain: none",
                                    "loop: acquire / drain: readback",
                                    "loop: parse / drain: none", "loop: h2d / drain: none"]
    assert [v for _k, v in got] == pytest.approx([1e-3, 0.3e-3, 0.1e-3, 0.1e-3])
    assert spans.idle_by_span(tr, _outcome(columns=3).records) is None
    assert spans.idle_by_span(dataclasses.replace(tr, clock=None), _outcome().records) is None


@pytest.mark.parametrize("name", ["to_submit_ms.stream", "service_ms.stream"])
def test_widened_records_read_as_the_three_columns(name):
    read = loader.reader(name)
    wide, old = _outcome(), _outcome(columns=3)
    assert wide.records.shape[1] == len(spans.COLUMNS) and old.records.shape[1] == 3
    np.testing.assert_array_equal(wide.records[:, :3], old.records)
    assert read(wide) == read(old) == pytest.approx(6.6 if name == "to_submit_ms.stream" else 1.6)


def test_records_of_keeps_three_columns_of_records_without_spans():
    old = type("R", (), {"t_first_byte_ns": 1, "t_submit_ns": 2, "t_done_ns": 3})()
    eng = type("E", (), {"stats": type("S", (), {"records": [old]})()})()
    np.testing.assert_array_equal(spans.records_of(eng), [[1, 2, 3]])


@pytest.mark.filterwarnings("ignore:CUDA is not available")
def test_clock_maps_a_profiled_op_inside_its_stamped_interval():
    """A torch CPU op run between two monotonic stamps lies between them
    on the profiler's clock once they are mapped there, and the mapping
    goes back to the same stamps."""
    got = {}

    def work():
        got["a"] = time.monotonic_ns()
        time.sleep(0.002)
        torch.ones(64, 64) @ torch.ones(64, 64)
        time.sleep(0.002)
        got["b"] = time.monotonic_ns()

    prof = spans.profile_for(0.02, work)
    clock = spans.clock_of(prof)
    assert clock is not None and all(p[2] > 0 for p in clock.pairs)
    (op,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    a, b = clock.to_trace([got["a"], got["b"]])
    assert a <= op.start_ns() <= op.end_ns() <= b
    np.testing.assert_array_equal(clock.to_mono([a, b]), [got["a"], got["b"]])
    tr = spans.summarize(prof)  # no device operation on the CPU
    assert tr is None
