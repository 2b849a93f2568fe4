"""Profiling a steady stretch of a run's window and reducing its trace.

``StretchProfiler`` runs ``torch.profiler`` (CPU and CUDA activities) on a
thread of its own, from a start to a stop time on the monotonic clock, so
that the serving loop is not touched: the device's kernels and copies and
the host's CUDA runtime calls come from CUPTI, whichever thread made them.
``summarize`` reduces the trace to what the metric readers take: every
device operation with its start and end, the stretch from the first to the
last of them, the union of their intervals (busy), the idle gaps, and the
runtime calls the host was in during each gap.

CUPTI now and then hands back a session's copies without any of its
kernels.  Such a trace is no reading of the kernels, so the profiler then
profiles another stretch of the same length, as long as the traffic still
runs (a profiled run's senders go on past the window for that).
"""

from __future__ import annotations

import bisect
import dataclasses
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

# the device operations that are not kernels
COPY = re.compile(r"^(Memcpy|Memset)")
NO_CALL = "no thread in a CUDA call (ring, parse, validate, reply: Python and numpy)"


@dataclasses.dataclass
class Trace:
    ops: List[Tuple[str, int, int]]       # device operations (name, start ns, end ns)
    calls: List[Tuple[str, int, int]]     # host CUDA runtime calls (name, start ns, end ns)
    start: int
    end: int
    busy_ns: int
    gaps: List[Tuple[int, int]]

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def named(self, pattern: str) -> List[Tuple[str, int, int]]:
        """The device operations whose name matches ``pattern`` (a regex,
        case-insensitive)."""
        rx = re.compile(pattern, re.I)
        return [o for o in self.ops if rx.search(o[0])]

    def count(self, pattern: str) -> int:
        return len(self.named(pattern))

    def seconds(self, pattern: str) -> float:
        return sum(e - s for _, s, e in self.named(pattern)) / 1e9

    @property
    def kernels(self) -> int:
        """Device operations that are neither copies nor fills."""
        return sum(1 for n, _s, _e in self.ops if not COPY.match(n))


def short_name(name: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    n = name.replace("(anonymous namespace)::", "")
    n = re.sub(r"^void ", "", n)
    depth, cut = 0, len(n)
    for i, ch in enumerate(n):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return n[:cut][:120]


def summarize(prof) -> Optional[Trace]:
    """The trace of a stopped ``torch.profiler.profile``; None when it
    holds no device operation."""
    from torch.autograd import DeviceType

    ops, calls = [], []
    for e in prof.profiler.kineto_results.events():
        s, t = int(e.start_ns()), int(e.end_ns())
        if e.device_type() == DeviceType.CUDA:
            ops.append((e.name(), s, t))
        elif e.name().startswith("cuda"):
            calls.append((e.name(), s, t))
    if not ops:
        return None
    ops.sort(key=lambda o: o[1])
    busy, gaps = 0, []
    cur_s, cur_e = ops[0][1], ops[0][2]
    for _n, s, e in ops[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return Trace(ops, calls, ops[0][1], max(e for _n, _s, e in ops), busy, gaps)


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps by the
    CUDA runtime calls the host's threads were in at each gap's middle."""
    by_op: Dict[str, int] = {}
    for n, s, e in tr.ops:
        k = short_name(n)
        by_op[k] = by_op.get(k, 0) + e - s
    calls = sorted(tr.calls, key=lambda c: c[1])
    starts = [c[1] for c in calls]
    by_gap: Dict[str, int] = {}
    width = max((c[2] - c[1] for c in calls), default=0)
    for a, b in tr.gaps:
        mid = (a + b) // 2
        lo = bisect.bisect_left(starts, mid - width)
        hi = bisect.bisect_right(starts, mid)
        inside = sorted({n for n, s, e in calls[lo:hi] if s <= mid < e})
        k = " + ".join(inside) if inside else NO_CALL
        by_gap[k] = by_gap.get(k, 0) + b - a
    rank = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_gap)}


def profile_for(seconds: float, work: Optional[Callable[[], None]] = None):
    """A ``torch.profiler.profile`` (CPU and CUDA activities) that runs
    ``work`` if given, lasts ``seconds`` from now, and is stopped."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t = time.monotonic() + seconds
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    if work is not None:
        work()
    time.sleep(max(0.0, t - time.monotonic()))
    prof.stop()
    return prof


class StretchProfiler:
    """Profile from ``times()[0]`` to ``times()[1]`` (monotonic seconds)
    on a thread of its own.  ``times`` returns None until the stretch is
    known, then ``(start, stop, last)``; the thread polls it.  A stretch
    whose trace holds no kernel is profiled again, for as long, right
    after, while the next one can stop by ``last``.  ``attempts`` lists
    each stretch's (device operations, kernels); ``trace`` is the first
    with a kernel, else the last.  ``on_end`` is called when the thread is
    done, whichever way."""

    def __init__(self, times: Callable[[], Optional[Tuple[float, float, float]]],
                 give_up: Callable[[], bool], profile: Callable = profile_for,
                 on_end: Optional[Callable[[], None]] = None):
        self._times = times
        self._give_up = give_up
        self._profile = profile
        self._on_end = on_end
        self.trace: Optional[Trace] = None
        self.error: Optional[str] = None
        self.attempts: List[Tuple[int, int]] = []
        self.warm: List[int] = []  # the warm-up sessions' kernels (serve.warm_profiler)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while (t := self._times()) is None:
                if self._give_up():
                    return
                time.sleep(0.01)
            start, stop, last = t
            time.sleep(max(0.0, start - time.monotonic()))
            while True:
                tr = summarize(self._profile(stop - time.monotonic()))
                self.attempts.append((0, 0) if tr is None else (len(tr.ops), tr.kernels))
                if tr is not None or self.trace is None:
                    self.trace = tr
                if tr is not None and tr.kernels:
                    return
                span, start = stop - start, time.monotonic()
                stop = start + span
                if stop > last:
                    return
        except Exception as e:  # noqa: BLE001 - reported beside the run's result
            self.error = repr(e)
        finally:
            if self._on_end is not None:
                self._on_end()

    def join(self, timeout: float = 120.0):
        self._thread.join(timeout)
