"""One benchmark run of a cell: the port's served path on one card under
the cell's traffic, then the comparison with the plain reference.

The path is the port's own assembly (``serving/compose.py``'s parts):
``build_engine`` (``ServingEngine.from_model``), an ``IngestServer`` (the
native ingest tier) on free ports, ``run_from_ingest`` with replies to
sender 0.  The load generator is a child process (``client.py``).  A
back-to-back run ends when the senders stop: ``run_from_ingest``'s ring
acquire times out (``end_timeout_ms``) and raises ``TimeoutError``, after
which the engine is drained.
"""

from __future__ import annotations

import dataclasses
import gc
import io
import json
import os
import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np

from . import inputs, reference, tables
from .readers import READBACK
from .trace import StretchProfiler, breakdown, profile_for, summarize

HERE = os.path.dirname(os.path.abspath(__file__))
STREAM_BATCHES = 1 << 40  # a back-to-back run's count: it ends by the ring's timeout
PROFILE_SPAN_S = 4.0      # the profiled stretch: at most this long, ending at the
PROFILE_SHARE = 0.2       # window's close, at most this share of the window
TRACE_TAIL_S = 12.0       # a profiled run's senders go on at most this long past the
                          # window's close, so that a stretch CUPTI recorded without
                          # its kernels can be profiled again (trace.StretchProfiler);
                          # they stop once the profiler is done (Client.stop)
WARM_PROFILES = 3         # profiler warm-ups tried until one records a kernel


@dataclasses.dataclass
class Cell:
    name: str
    config: str
    chips: int
    model: dict
    serve: dict
    check: dict
    traffic: dict


@dataclasses.dataclass
class Outcome:
    """What a run measured, for the metric readers."""
    cell: Cell
    seconds: float
    head: dict                 # the load generator's header
    recv_ns: np.ndarray
    replies: np.ndarray        # [n_recv, B] float32
    records: np.ndarray        # [n, 3] int64: first byte, submit, done (engine batch order)
    setup_s: float
    memory_peak: int
    trace: object              # trace.Trace of the profiled stretch, or None
    errors: List[str]
    seed: int = 0
    checks: Optional[dict] = None
    stamps: Optional[dict] = None  # set-up phases: name -> monotonic ns at its end
    check_s: float = 0.0
    profiled: Optional[str] = None  # the profiler's sessions, for standard error
    after: Optional[dict] = None    # phases after the window: name -> monotonic ns at its end

    def setup_phases(self, t_start: int) -> str:
        """The set-up's phases in seconds, in order."""
        marks = sorted((self.stamps or {}).items(), key=lambda kv: kv[1])
        marks.append(("senders warm, window open", self.head["t_open_ns"]))
        out, prev = [], t_start
        for name, t in marks:
            out.append(f"{name} {(t - prev) / 1e9:.3f}")
            prev = t
        return ", ".join(out)

    def after_phases(self) -> str:
        """The phases after the window's close in seconds, in order."""
        out, prev = [], self.head["t_close_ns"]
        for name, t in sorted((self.after or {}).items(), key=lambda kv: kv[1]):
            out.append(f"{name} {(t - prev) / 1e9:.3f}")
            prev = t
        return ", ".join(out)

    def expected(self) -> int:
        """The batches the run should have answered: all it sent."""
        return int(self.head["n_sent"])

    @property
    def batch(self) -> int:
        return self.cell.serve["batch"]

    @property
    def warm(self) -> int:
        return self.head["warm"]

    def window(self) -> np.ndarray:
        """Indices of the batches whose scores reached sender 0 inside the
        window."""
        t0, t1 = self.head["t_open_ns"], self.head["t_close_ns"]
        return np.flatnonzero((self.recv_ns > t0) & (self.recv_ns <= t1))


def now() -> int:
    return time.monotonic_ns()


def split_cores(n_client: int = 2):
    """Cores for the load generator (the last ``n_client`` this process
    may use) and for the server (the rest): the senders stand for other
    machines, so they get cores of their own.  None on a host of fewer than
    four cores."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return None
    return cores[:-n_client], cores[-n_client:]


class GcWatch:
    """The interpreter's garbage collections (start, end, generation), to
    tell their pauses apart from the program's in a run's diagnostics."""

    def __init__(self):
        import gc as gc_mod

        self.events, self._t = [], 0
        gc_mod.callbacks.append(self._cb)

    def _cb(self, phase, info):
        if phase == "start":
            self._t = now()
        else:
            self.events.append((self._t, now(), info["generation"]))

    def line(self, t0: int, t1: int) -> str:
        ev = [(a, b, g) for a, b, g in self.events if t0 <= a < t1]
        full = [b - a for a, b, g in ev if g == 2]
        return (f"garbage collections in the window: {len(ev)}, of the oldest generation "
                f"{len(full)} taking {sum(full) / 1e6:.3f} ms (longest "
                f"{max(full, default=0) / 1e6:.3f} ms); all of them {sum(b - a for a, b, _ in ev) / 1e6:.3f} ms")


def process_start_ns() -> int:
    """This process's start on the monotonic clock (from /proc's start
    time in clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    since = time.clock_gettime(time.CLOCK_BOOTTIME) - ticks / os.sysconf("SC_CLK_TCK")
    return time.monotonic_ns() - int(since * 1e9)


def wire_of(cfg, serve: dict, hot):
    """(IndexWireFormat or None, bytes a sender, the client's wire).  One
    sender sends a query's ids as ``inputs.py`` lays them out ([B,
    sum(hot)] int32), then its dense features; several senders split the
    tables by the port's ``IndexWireFormat`` (single ids only)."""
    from fleetrec_tpu_torch.serving import IndexWireFormat

    B, S, T, D = serve["batch"], serve["senders"], cfg.num_tables, cfg.dense_dim
    n_ids = sum(hot)
    if S > 1:
        if n_ids != T:
            raise ValueError(f"bags (hot {list(hot)}) on {S} senders: the port's "
                             f"IndexWireFormat splits single ids only")
        wire = IndexWireFormat.plan(cfg, B, S)
        segs, c = ([[("dense",)]] if wire.dense_dim else []), 0
        for n in wire.table_splits:
            segs.append([("ids", c, c + n)])
            c += n
        return wire, wire.bytes_per_sender(), segs
    return None, [B * (n_ids + D) * 4], [[("ids", 0, n_ids)] + ([("dense",)] if D else [])]


def bag_fields(hot, spec_fields) -> dict:
    """``ServeSpec``'s bag fields for a configuration's ``hot``: none for
    single ids; ``bag_sizes`` where the port's ServeSpec has that field
    (``spec_fields``), else ``bag_L`` for bags of one size.  Ragged bags
    that the port cannot take raise."""
    if all(h == 1 for h in hot):
        return {}
    if "bag_sizes" in spec_fields:
        return {"bag_sizes": tuple(hot)}
    if len(set(hot)) == 1:
        return {"bag_L": hot[0]}
    raise ValueError(f"ragged bags (hot {list(hot)}): the port's ServeSpec has no "
                     f"bag_sizes, and its bag_L serves bags of one size only")


class Client:
    """The load generator's child process."""

    def __init__(self, cell: Cell, seed: int, seconds: float, wire: list, cores=None,
                 tail_s: float = 0.0):
        self.tail_s = tail_s
        spec = {"seed": seed, "batch": cell.serve["batch"], "seconds": seconds, "tail_s": tail_s,
                "rows": [t["rows"] for t in cell.model["tables"]],
                "hot": inputs.hot_of(cell.model),
                "dense_dim": cell.model["dense_dim"], "wire": wire, "traffic": cell.traffic}
        self.proc = subprocess.Popen([sys.executable, os.path.join(HERE, "client.py")],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        if cores:
            os.sched_setaffinity(self.proc.pid, cores)
        self.proc.stdin.write((json.dumps(spec) + "\n").encode())
        self.proc.stdin.flush()

    def go(self, port_base: int):
        line = self.proc.stdout.readline()
        if line.strip() != b"ready":
            raise RuntimeError(f"the load generator did not start: {line!r}")
        self.proc.stdin.write((json.dumps({"port_base": port_base}) + "\n").encode())
        self.proc.stdin.flush()

    def result(self):
        buf = io.BytesIO(self.proc.stdout.read())
        self.proc.wait(timeout=60)
        head = json.loads(buf.readline())
        return head, [np.load(buf) for _ in range(2)]

    def stop(self):
        """Tell the load generator that the traffic's tail is not needed
        (it stops no earlier than the window's close)."""
        try:
            self.proc.stdin.write(b"stop\n")
            self.proc.stdin.flush()
        except (OSError, ValueError):
            pass

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()


def open_ingest(nbytes: List[int], slots: int, tries: int = 20):
    """An IngestServer on a free block of ports (the block is drawn at
    random and drawn again when a port of it is taken)."""
    from fleetrec_tpu_torch.serving import IngestServer

    rng = np.random.default_rng()
    for _ in range(tries):
        base = int(rng.integers(20000, 60000 - len(nbytes)))
        try:
            return IngestServer(nbytes, n_slots=slots, port_base=base)
        except OSError:
            continue
    raise OSError("no free block of ingest ports")


class Stretch:
    """The profiled stretch, fixed once the window opens: the window's last
    seconds, ending just past its close, so that stopping the profiler
    (which holds the interpreter for a while) falls after it; and the
    latest a stretch profiled again may stop, in the traffic's tail."""

    def __init__(self, eng, warm: int, seconds: float, tail_s: float):
        self.eng, self.warm, self.seconds, self.tail_s = eng, warm, seconds, tail_s
        self.t = None
        self.done = False

    def times(self):
        if self.t is None and len(self.eng.stats.records) >= self.warm:
            close = time.monotonic() + self.seconds
            self.t = (close - min(PROFILE_SPAN_S, PROFILE_SHARE * self.seconds), close + 0.05,
                      close + self.tail_s - 0.5)
        return self.t


def serve_window(eng, cfg, cell: Cell, client: Client, seconds: float, trace: bool):
    """Bind the ingest tier, start the senders and run the engine's loop
    until the traffic ends.  Returns the StretchProfiler (or None)."""
    if cell.traffic["kind"] != "stream":
        raise ValueError(f"{cell.name}: traffic kind {cell.traffic['kind']!r} is not 'stream'")
    t_warm = now()
    warm = warm_profiler() if trace else None
    warm_s = (now() - t_warm) / 1e9
    wire, nbytes, _ = wire_of(cfg, cell.serve, inputs.hot_of(cell.model))
    prof = None
    with open_ingest(nbytes, cell.serve["slots"]) as ing:
        client.go(ing.port_base)
        if trace:
            stretch = Stretch(eng, cell.traffic["warmup_batches"], seconds, client.tail_s)
            prof = StretchProfiler(stretch.times, lambda: stretch.done, on_end=client.stop)
        try:
            eng.run_from_ingest(ing, STREAM_BATCHES, wire=wire,
                                row_limits=[t.rows for t in cfg.tables], reply_to=0,
                                timeout_ms=cell.traffic["end_timeout_ms"])
        except TimeoutError:
            eng.drain()
        finally:
            if trace:
                stretch.done = True
            eng.close()
    if prof is not None:
        prof.join()
        prof.warm, prof.warm_s = warm, warm_s
    return prof


def warm_profiler() -> List[int]:
    """Profile a few kernels on this (the main) thread: the profiler's
    first start initializes CUPTI, which must happen on the thread that
    loaded it, and is slow; the profiled stretch then starts on another.
    Tried again, up to ``WARM_PROFILES`` times, until a session records a
    kernel.  Returns each session's kernel count."""
    import torch

    x = torch.ones(1 << 16, device="cuda")

    def work():
        for _ in range(4):
            x.mul_(1.0)
        torch.cuda.synchronize()

    counts = []
    while len(counts) < WARM_PROFILES and not any(counts):
        tr = summarize(profile_for(0.0, work))
        counts.append(0 if tr is None else tr.kernels)
    return counts


def records_of(eng) -> np.ndarray:
    return np.asarray([(r.t_first_byte_ns, r.t_submit_ns, r.t_done_ns)
                       for r in eng.stats.records], np.int64).reshape(-1, 3)


def check(out: Outcome, seed: int, device) -> None:
    """Compare every reply with the reference's scores of its pool entry;
    fills ``out.checks`` (each number with its limit)."""
    import torch

    t0 = now()
    cell = out.cell
    P = cell.traffic["pool_batches"]
    ids, dense = inputs.pools(seed, cell.model, out.batch, P)
    w = tables.head_weights(seed, cell.model, device)
    ref = reference.pool_scores(cell.model, tables.seed_key(seed), ids, dense, w)
    del w
    if str(device).startswith("cuda"):
        torch.cuda.empty_cache()
    n = len(out.replies)
    err = reference.max_err(out.replies, ref[np.arange(n) % P]) if n else float("inf")
    out.checks = {
        "max_err": {"value": err, "limit": cell.check["max_err"]},
        "unanswered": {"value": out.expected() - n, "limit": 0},
        "wire_errors": {"value": len(out.head["errors"]), "limit": 0},
    }
    out.check_s = (now() - t0) / 1e9


def correct(out: Outcome) -> bool:
    return all(c["value"] <= c["limit"] for c in out.checks.values())


def run_single(cell: Cell, seed: int, seconds: float, trace: bool, t_start: int,
               device="cuda", patch: Optional[Callable] = None,
               stamps: Optional[dict] = None, client_cores=None) -> Outcome:
    """One run on one device."""
    import torch

    from fleetrec_tpu_torch.serving import ServeSpec, build_engine

    from .model import build_model, port_config

    if patch is not None:
        patch()
    cfg = port_config(cell.config, cell.model, cell.serve)
    hot = inputs.hot_of(cell.model)
    bags = bag_fields(hot, {f.name for f in dataclasses.fields(ServeSpec)})
    client = Client(cell, seed, seconds, wire_of(cfg, cell.serve, hot)[2], client_cores,
                    tail_s=TRACE_TAIL_S if trace else 0.0)
    stamps = dict(stamps or {})
    stamps["the port imported, the load generator started"] = now()
    try:
        dev = torch.device(device)
        model = build_model(cfg, cell.model, seed, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        stamps["tables and weights on the device"] = time.monotonic_ns()
        sv = cell.serve
        spec = ServeSpec(batch=sv["batch"], batches=0, slots=sv["slots"], senders=sv["senders"],
                         fuse=sv["fuse"], bg_drain=sv["bg_drain"], reply=True, warm=sv["warm"],
                         **bags)
        eng = build_engine(model, spec)
        if spec.warm:
            eng.warmup()
        stamps["engine warm-up (kernels loaded)"] = time.monotonic_ns()
        prof = serve_window(eng, cfg, cell, client, seconds, trace)
        after = {"traffic ended, the profiled stretch reduced": now()}
        head, (recv, replies) = client.result()
        after["the load generator's replies read"] = now()
    finally:
        client.kill()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    records = records_of(eng)
    del eng, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    after["the program's state freed"] = now()
    errors = [] if prof is None or prof.error is None else [f"profiler: {prof.error}"]
    if prof is not None and (prof.trace is None or not prof.trace.kernels):
        errors.append("profiler: no kernel in any profiled stretch")
    # the profiler's warm-up (CUPTI's first session, ~10 s on the card) is
    # the harness's instrument, not the system's set-up: left out of setup_s
    warm_s = 0.0 if prof is None else prof.warm_s
    out = Outcome(cell, seconds, head, recv, replies, records,
                  (head["t_open_ns"] - t_start) / 1e9 - warm_s, peak,
                  None if prof is None else prof.trace, errors, seed, stamps=stamps, after=after)
    if prof is not None:
        out.profiled = (f"profiler: warm-up {warm_s:.3f} s (not in setup_s), its sessions' "
                        f"kernels {prof.warm}; stretches' "
                        f"(device operations, kernels) {prof.attempts}")
    check(out, seed, dev)
    out.after["the reference's check"] = now()
    return out


def diagnostics(out: Outcome) -> List[str]:
    """Lines for standard error: the window second by second, and the
    engine's stamps' medians and 95th percentiles."""
    lines = []
    t0, t1 = out.head["t_open_ns"], out.head["t_close_ns"]
    if t1 > t0 and len(out.recv_ns):
        edges = np.arange(t0, t1 + 1, 1_000_000_000)
        per = np.histogram(out.recv_ns, bins=edges)[0]
        lines.append(f"replies a second of the window: {per.tolist()}")
    j = out.window()
    j = j[j < len(out.records)]
    if len(j):
        r = out.records[j] / 1e6
        for name, d in (("to_submit", r[:, 1] - r[:, 0]), ("service", r[:, 2] - r[:, 1])):
            lines.append(f"{name} ms: p50 {np.median(d):.4f}, p95 {np.percentile(d, 95):.4f}")
    if out.profiled is not None:
        lines.append(out.profiled)
    if out.trace is not None and out.trace.count(READBACK):
        n = out.trace.count(READBACK)
        ops = breakdown(out.trace)["device_ops"]
        lines.append(f"the stretch: {n} score readbacks, device busy {out.trace.busy_s:.6f} s of "
                     f"{out.trace.window_s:.6f}; device ms a batch by operation: "
                     + ", ".join(f"{k} {v * 1e3 / n:.5f}" for k, v in ops))
    lines.append(f"the comparison with the reference took {out.check_s:.3f} s")
    return lines


def device_block(out: Outcome, kind: str, trace: bool) -> dict:
    """The result line's ``device`` object."""
    dev = {"platform": "gpu", "kind": kind, "count": out.cell.chips,
           "memory_peak_bytes": int(out.memory_peak)}
    if trace and out.trace is not None:
        dev["busy_s"] = float(out.trace.busy_s)
        dev["window_s"] = float(out.trace.window_s)
    return dev


def trace_breakdown(out: Outcome) -> Optional[dict]:
    return None if out.trace is None else breakdown(out.trace)
