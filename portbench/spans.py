#!/usr/bin/env python3
"""The serving engine's per-batch spans, laid on the device trace's clock.

The engine stamps every layer boundary a batch crosses on its loop and
drain threads (``serving/engine.py``: ``BatchRecord``, ``SPANS``), on the
monotonic clock.  The profiler stamps its events on a clock of its own.
Here the profiling thread brackets a profiler event between two monotonic
reads at the start and at the stop of each profiled stretch
(``profile_for``); the two brackets map the one clock onto the other
(``Clock``), and each idle gap of the device is put down to the span the
loop thread and the drain thread were in at the gap's middle
(``idle_by_span``, the middle rule of ``trace.breakdown``).  ``READERS``
holds the per-layer numbers the spans give, each a ``read(out)`` of a
run's ``serve.Outcome`` that returns None where the run holds nothing to
read it from: records without the spans' columns, or no mapped trace.

The benchmark's own run (``run.py``) keeps three columns of the records and
profiles without brackets.  One traced run of a cell with the spans wired
in, from the root of a checkout, on a machine with a CUDA device:

    python3 portbench/spans.py --workload <name> --seed <n> --seconds <s>

prints the seven span readings, the existing per-layer metrics, the idle
gaps by span, the clock's brackets and drift, the share of ``h2d`` spans
holding a host-to-device copy call and the share of the window the loop
thread's spans cover, as one JSON object on its last line of standard
output; the spans' medians and 95th percentiles go to standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script
    sys.path.insert(0, ROOT)

from fleetrec_tpu_torch.serving.engine import SPANS  # noqa: E402
from portbench import trace  # noqa: E402
from portbench.readers import READBACK  # noqa: E402
from portbench.trace import Trace, summarize as trace_summarize  # noqa: E402

# the records' columns: the three ``serve.records_of`` keeps, then every
# other stamp of the engine's spans (``BatchRecord``'s names), and the spans
# of each thread
THREE = ("t_first_byte_ns", "t_submit_ns", "t_done_ns")
COLUMNS = THREE + tuple(dict.fromkeys(t for _n, _w, a, b in SPANS for t in (a, b)
                                      if t not in THREE))
COL = {c: k for k, c in enumerate(COLUMNS)}
SPAN = {n: (a, b) for n, _w, a, b in SPANS}
LOOP = tuple(n for n, w, _a, _b in SPANS if w == "loop")
DRAIN = tuple(n for n, w, _a, _b in SPANS if w == "drain")
# the loop's host work: the device idle in these is put down to the host
HOST_WORK = ("parse", "validate", "h2d", "dispatch")
NONE = "none"
MARK = "portbench.clock"
BRACKET_TRIES = 3
HTOD = "Memcpy HtoD"


def records_of(eng) -> np.ndarray:
    """The engine's records, one row a batch in ``COLUMNS``' order; only
    the first three where the engine's records have no span stamps."""
    recs = eng.stats.records
    cols = COLUMNS if recs and all(hasattr(recs[0], c) for c in COLUMNS) else COLUMNS[:3]
    return np.asarray([[getattr(r, c) for c in cols] for r in recs],
                      np.int64).reshape(-1, len(cols))


def has_spans(records: np.ndarray) -> bool:
    return records.ndim == 2 and records.shape[1] == len(COLUMNS)


def span_ns(records: np.ndarray, name: str) -> np.ndarray:
    a, b = SPAN[name]
    return records[:, COL[b]] - records[:, COL[a]]


# -- one clock with the device trace ---------------------------------------

def bracket(k: int) -> Dict[str, Tuple[int, int, int]]:
    """Enter and leave a profiler range between two monotonic reads, a few
    times: name -> (monotonic before, monotonic after, CLOCK_REALTIME
    inside).  The narrowest pair bounds where the range's start sits on the
    monotonic clock."""
    import torch

    out = {}
    for j in range(BRACKET_TRIES):
        name = f"{MARK}.{k}.{j}"
        a = time.monotonic_ns()
        with torch.profiler.record_function(name):
            wall = time.time_ns()
        out[name] = (a, time.monotonic_ns(), wall)
    return out


@dataclasses.dataclass
class Clock:
    """The profiler's clock against the monotonic one, from a bracket at
    the start and one at the stop of a stretch.  ``pairs``: for each
    bracket (monotonic middle, profiler middle, bracket width, CLOCK_REALTIME
    inside minus the profiler middle), all ns."""
    pairs: List[Tuple[int, int, int, int]]

    def _drift(self, t: np.ndarray) -> np.ndarray:
        """The offset at monotonic ``t`` less the first bracket's: drawn
        linearly from one bracket to the other (int64 throughout, as the
        profiler's ns pass what a float64 holds exactly)."""
        (m0, p0, _, _), (m1, p1, _, _) = self.pairs
        d = (p1 - m1) - (p0 - m0)
        return np.round(d * (t - m0) / max(m1 - m0, 1)).astype(np.int64)

    def to_trace(self, t) -> np.ndarray:
        """Monotonic ns -> the profiler's ns."""
        m0, p0 = self.pairs[0][:2]
        t = np.asarray(t, np.int64)
        return t + (p0 - m0) + self._drift(t)

    def to_mono(self, u) -> np.ndarray:
        """The profiler's ns -> monotonic ns (``to_trace`` undone; the
        drift is microseconds over seconds, so one step settles it)."""
        m0, p0 = self.pairs[0][:2]
        t = np.asarray(u, np.int64) - (p0 - m0)
        return t - self._drift(t)

    @property
    def drift_ns(self) -> int:
        return self.pairs[1][1] - self.pairs[1][0] - (self.pairs[0][1] - self.pairs[0][0])

    def summary(self) -> dict:
        return {"bracket_ns": [p[2] for p in self.pairs], "drift_ns": self.drift_ns,
                "realtime_minus_profiler_ns": [p[3] for p in self.pairs],
                "stretch_s": (self.pairs[1][0] - self.pairs[0][0]) / 1e9}


def clock_of(prof) -> Optional[Clock]:
    """The Clock of a profile taken by ``profile_for``, from its narrowest
    bracket at the start and at the stop; None without both."""
    marks = getattr(prof, "portbench_brackets", None) or {}
    seen = {e.name(): (int(e.start_ns()), int(e.end_ns()))
            for e in prof.profiler.kineto_results.events() if e.name() in marks}
    pairs = []
    for k in (0, 1):
        tries = [(b - a, n) for n, (a, b, _w) in marks.items()
                 if n.startswith(f"{MARK}.{k}.") and n in seen]
        if not tries:
            return None
        _, n = min(tries)
        a, b, wall = marks[n]
        s, e = seen[n]
        pairs.append(((a + b) // 2, (s + e) // 2, b - a, wall - (s + e) // 2))
    return Clock(pairs)


def profile_for(seconds: float, work=None):
    """``trace.profile_for`` with a bracket after the start and one before
    the stop (``clock_of``)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t = time.monotonic() + seconds
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    marks = bracket(0)
    if work is not None:
        work()
    time.sleep(max(0.0, t - time.monotonic()))
    marks.update(bracket(1))
    prof.stop()
    prof.portbench_brackets = marks
    return prof


@dataclasses.dataclass
class SpanTrace(Trace):
    """A ``trace.Trace`` with its clock and the host's calls that copied
    into the device (each correlated with a host-to-device copy)."""
    clock: Optional[Clock] = None
    copies_in: List[Tuple[int, int]] = dataclasses.field(default_factory=list)


def copies_in(prof) -> List[Tuple[int, int]]:
    """The host runtime calls (start, end) whose device operation is a
    host-to-device copy, by the profiler's correlation ids."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    ids = set()
    for e in events:
        if e.device_type() == DeviceType.CUDA and e.name().startswith(HTOD):
            ids.update((e.correlation_id(), e.linked_correlation_id()))
    ids.discard(0)
    return sorted((int(e.start_ns()), int(e.end_ns())) for e in events
                  if e.device_type() != DeviceType.CUDA and e.name().startswith("cudaMemcpy")
                  and (e.correlation_id() in ids or e.linked_correlation_id() in ids))


def summarize(prof) -> Optional[SpanTrace]:
    """``trace.summarize`` with the clock and the copy calls."""
    tr = trace_summarize(prof)
    if tr is None:
        return None
    base = {f.name: getattr(tr, f.name) for f in dataclasses.fields(Trace)}
    return SpanTrace(**base, clock=clock_of(prof), copies_in=copies_in(prof))


# -- idle gaps by span ------------------------------------------------------

def label_at(records: np.ndarray, spans, t: np.ndarray) -> np.ndarray:
    """The span of one thread (``spans``: LOOP or DRAIN) that holds each
    monotonic time of ``t``, or NONE.  A thread's spans do not overlap."""
    starts, ends, names = [], [], []
    for name in spans:
        a, b = SPAN[name]
        s, e = records[:, COL[a]], records[:, COL[b]]
        keep = (s > 0) & (e > s)
        starts.append(s[keep])
        ends.append(e[keep])
        names += [name] * int(keep.sum())
    t = np.asarray(t, np.int64)
    if not names:
        return np.full(len(t), NONE, object)
    order = np.argsort(np.concatenate(starts), kind="stable")
    starts, ends = np.concatenate(starts)[order], np.concatenate(ends)[order]
    names = np.asarray(names, object)[order]
    i = np.searchsorted(starts, t, side="right") - 1
    j = np.maximum(i, 0)
    return np.where((i >= 0) & (t < ends[j]), names[j], NONE)


def _gap_labels(tr, records):
    if tr is None or getattr(tr, "clock", None) is None or not has_spans(records) \
            or not tr.gaps:
        return None
    gaps = np.asarray(tr.gaps, np.int64)
    mono = tr.clock.to_mono((gaps[:, 0] + gaps[:, 1]) // 2)
    return gaps[:, 1] - gaps[:, 0], label_at(records, LOOP, mono), label_at(records, DRAIN, mono)


def idle_by_span(tr, records: np.ndarray) -> Optional[list]:
    """The stretch's idle seconds by the spans the loop and the drain
    thread were in at each gap's middle, ``[["loop: <span> / drain: <span>",
    seconds], ...]``, most first; None without a mapped trace or spans."""
    got = _gap_labels(tr, records)
    if got is None:
        return None
    dur, loop, drain = got
    by: Dict[str, int] = {}
    for d, lo, dr in zip(dur.tolist(), loop, drain):
        k = f"loop: {lo} / drain: {dr}"
        by[k] = by.get(k, 0) + d
    return [[k, v / 1e9] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def idle_host_ns(tr, records: np.ndarray) -> Optional[int]:
    """The stretch's idle ns whose gap middle lies in the loop's host work
    (``HOST_WORK``)."""
    got = _gap_labels(tr, records)
    if got is None:
        return None
    dur, loop, _ = got
    return int(dur[np.isin(loop, HOST_WORK)].sum())


# -- the readers -------------------------------------------------------------

def window_records(out) -> Optional[np.ndarray]:
    """The window's records with the spans' columns, or None."""
    if not has_spans(out.records):
        return None
    j = out.window()
    j = j[j < len(out.records)]
    return out.records[j] if len(j) else None


def median_ms(name: str):
    def read(out):
        r = window_records(out)
        return None if r is None else float(np.median(span_ns(r, name)) / 1e6)
    return read


def loop_busy(out) -> Optional[float]:
    """100 x the window's batches' parse + validate + h2d + dispatch over
    the window's seconds."""
    r = window_records(out)
    if r is None:
        return None
    busy = sum(int(span_ns(r, n).sum()) for n in HOST_WORK)
    return 100.0 * busy / 1e9 / out.seconds


def idle_host_ms(out) -> Optional[float]:
    """The stretch's device idle in the loop's host work, a served batch
    (its score readback, as ``tower_roofline.stream`` counts them)."""
    tr = out.trace
    ns = idle_host_ns(tr, out.records)
    n = 0 if tr is None else tr.count(READBACK)
    return None if ns is None or not n else ns / n / 1e6


READERS = {
    "ring_wait_ms.stream": median_ms("ring_wait"),
    "parse_ms.stream": median_ms("parse"),
    "validate_ms.stream": median_ms("validate"),
    "h2d_ms.stream": median_ms("h2d"),
    "dispatch_ms.stream": median_ms("dispatch"),
    "loop_busy.stream": loop_busy,
    "idle_host_ms.stream": idle_host_ms,
}


# -- checks of the mapping and the tiling -----------------------------------

def h2d_with_copy(tr, records: np.ndarray) -> Optional[dict]:
    """Of the ``h2d`` spans that lie in the stretch once mapped, how many
    hold a whole host-to-device copy call."""
    if tr is None or getattr(tr, "clock", None) is None or not has_spans(records):
        return None
    a, b = (tr.clock.to_trace(records[:, COL[c]]) for c in SPAN["h2d"])
    inside = (a >= tr.start) & (b <= tr.end) & (records[:, COL["t_submit_ns"]] > 0)
    calls = np.asarray(tr.copies_in, np.int64).reshape(-1, 2)
    starts = calls[:, 0]
    n_with = 0
    for s, e in zip(a[inside], b[inside]):
        lo = np.searchsorted(starts, s, side="left")
        hi = np.searchsorted(starts, e, side="right")
        n_with += bool((calls[lo:hi, 1] <= e).any())
    n = int(inside.sum())
    return {"spans": n, "with_copy": n_with, "share": n_with / n if n else None,
            "copy_calls": len(calls), "htod_ops": tr.count(f"^{HTOD}"),
            "memcpy_calls": sum(c[0].startswith("cudaMemcpy") for c in tr.calls)}


def loop_cover(out) -> Optional[float]:
    """The share of the window's wall time that the loop thread's spans
    (acquire through dispatch) cover."""
    if not has_spans(out.records):
        return None
    t0, t1 = out.head["t_open_ns"], out.head["t_close_ns"]
    s = np.clip(out.records[:, COL["t_acquire_call_ns"]], t0, t1)
    e = np.clip(out.records[:, COL["t_dispatched_ns"]], t0, t1)
    order = np.argsort(s)
    cover, reach = 0, t0
    for a, b in zip(s[order].tolist(), e[order].tolist()):
        a = max(a, reach)
        if b > a:
            cover += b - a
            reach = b
    return cover / (t1 - t0) if t1 > t0 else None


def span_lines(out) -> List[str]:
    """p50 / p95 of each span over the window's batches, for standard
    error."""
    r = window_records(out)
    if r is None:
        return []
    lines = []
    for name in ("ring_wait",) + LOOP + DRAIN:
        d = span_ns(r, name) / 1e6
        lines.append(f"{name} ms: p50 {np.median(d):.4f}, p95 {np.percentile(d, 95):.4f}")
    return lines


def wire(serve_mod, trace_mod) -> None:
    """Have a run keep the spans' columns and profile with brackets."""
    serve_mod.records_of = records_of
    serve_mod.StretchProfiler = functools.partial(trace_mod.StretchProfiler, profile=profile_for)
    trace_mod.summarize = summarize


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one traced run of a cell with the engine's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from portbench import run

    for var, sub in run.CACHES:
        os.environ[var] = os.path.join(run.ROOT, ".portbench_cache", sub)
    for var in run.ONE_THREAD:
        os.environ[var] = "1"
    from portbench import loader, serve

    t_start = serve.process_start_ns()
    cell = loader.cell(args.workload)
    import torch

    torch.set_num_threads(1)
    stamps = {"python, torch imported": serve.now()}
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA devices", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    torch.cuda.init()
    stamps["CUDA initialized"] = serve.now()
    split = serve.split_cores()
    if split is not None:
        os.sched_setaffinity(0, split[0])
    out = serve.run_single(cell, args.seed, args.seconds, True, t_start, stamps=stamps,
                           patch=lambda: wire(serve, trace),
                           client_cores=None if split is None else split[1])
    metrics = {n: f(out) for n, f in READERS.items()}
    for m in loader.metrics(args.workload, True):
        metrics[m["name"]] = loader.reader(m["name"])(out)
    tr = out.trace
    result = {"correct": serve.correct(out), "metrics": metrics,
              "device": serve.device_block(out, kind, True),
              "breakdown": dict(serve.trace_breakdown(out) or {},
                                idle_by_span=idle_by_span(tr, out.records)),
              "clock": None if getattr(tr, "clock", None) is None else tr.clock.summary(),
              "h2d_with_copy": h2d_with_copy(tr, out.records), "loop_cover": loop_cover(out),
              "checks": out.checks}
    print(f"card: {run.card_line()}", file=sys.stderr)
    for line in serve.diagnostics(out) + span_lines(out):
        print(line, file=sys.stderr)
    for e in out.errors + out.head["errors"]:
        print(f"error: {e}", file=sys.stderr)
    found = run.forbidden_modules()
    if found:
        print(f"the run loaded {found}", file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
