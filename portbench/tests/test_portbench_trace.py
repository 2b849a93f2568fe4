"""The profiled stretch: a trace that CUPTI handed back with its copies and
none of its kernels is profiled again while the traffic's tail allows, and
the trace's kernels are told from its copies and fills."""

from __future__ import annotations

import threading
import time

import pytest
from torch.autograd import DeviceType

from portbench.trace import StretchProfiler, summarize


class Event:
    def __init__(self, name, start, end, device=DeviceType.CUDA):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return self._d


class Prof:
    """What ``summarize`` reads of a stopped ``torch.profiler.profile``."""

    def __init__(self, events):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda _self: events})()


COPIES = [Event("Memcpy HtoD (Pageable -> Device)", 0, 10), Event("Memset (Device)", 20, 25),
          Event("cudaMemcpyAsync", 0, 12, DeviceType.CPU)]
KERNELS = COPIES + [Event("void ffma_product<128, 128>(float const*)", 30, 90),
                    Event("void lookup_fused_kernel<signed char, int, false>()", 100, 120)]


def sessions(*traces):
    """A profile function that hands back ``traces`` in turn, each session
    as long as it was asked to be."""
    left = list(traces)

    def profile(seconds, work=None):
        time.sleep(max(0.0, seconds))
        return Prof(left.pop(0))
    return profile


def run(profile, span: float, tail: float) -> StretchProfiler:
    t0 = time.monotonic()
    p = StretchProfiler(lambda: (t0, t0 + span, t0 + tail), lambda: False, profile=profile)
    p.join(10.0)
    assert p.error is None
    return p


def test_summarize_tells_kernels_from_copies():
    assert summarize(Prof(COPIES)).kernels == 0
    tr = summarize(Prof(KERNELS))
    assert tr.kernels == 2 and len(tr.ops) == 4
    assert tr.busy_ns == 10 + 5 + 60 + 20 and tr.window_s == 120 / 1e9
    assert summarize(Prof(COPIES[2:])) is None


@pytest.mark.parametrize("first, second, tail, attempts, kernels", [
    (KERNELS, None, 1.0, [(4, 2)], 2),                    # read at once
    (COPIES, KERNELS, 1.0, [(2, 0), (4, 2)], 2),          # profiled again in the tail
    (COPIES, KERNELS, 0.07, [(2, 0)], 0),                 # no room left for a second stretch
    (COPIES[2:], KERNELS, 1.0, [(0, 0), (4, 2)], 2),      # no device operation at all
])
def test_a_stretch_without_kernels_is_profiled_again(first, second, tail, attempts, kernels):
    p = run(sessions(first, second), span=0.05, tail=tail)
    assert p.attempts == attempts
    assert (p.trace.kernels if p.trace is not None else 0) == kernels


def test_the_last_trace_stands_where_no_stretch_holds_a_kernel():
    p = run(sessions(COPIES, COPIES, COPIES, COPIES), span=0.1, tail=0.35)
    assert p.attempts == [(2, 0)] * 3
    assert p.trace is not None and p.trace.kernels == 0


def test_the_load_generators_tail_ends_at_stop_but_not_before_the_close():
    import os

    from portbench.client import Run

    r, w = os.pipe()
    try:
        run = Run.__new__(Run)
        t0 = time.monotonic_ns()
        run.stop_fd, run.t_close = r, t0 + 300_000_000
        os.write(w, b"stop\n")
        run.wait_until(t0 + 10_000_000_000)  # a 10 s tail
        waited = (time.monotonic_ns() - t0) / 1e9
        assert 0.3 <= waited < 2.0
        run.stop_fd, run.t_close = r, time.monotonic_ns()
        t1 = time.monotonic()
        threading.Timer(0.2, lambda: os.write(w, b"stop\n")).start()
        run.wait_until(time.monotonic_ns() + 10_000_000_000)
        assert 0.2 <= time.monotonic() - t1 < 2.0
    finally:
        os.close(r)
        os.close(w)


def test_the_profiler_calls_on_end_whichever_way_it_ends():
    ended = []
    t0 = time.monotonic()
    p = StretchProfiler(lambda: (t0, t0 + 0.05, t0 + 0.05), lambda: False,
                        profile=sessions([Event("Memcpy HtoD", 0, 1)]), on_end=lambda: ended.append(1))
    p.join(10.0)
    assert ended == [1]
    p = StretchProfiler(lambda: None, lambda: True, on_end=lambda: ended.append(2))
    p.join(10.0)
    assert ended == [1, 2]
