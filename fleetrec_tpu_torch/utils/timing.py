"""Timing utilities, the port of ``fleetrec_tpu/utils/timing.py``.

``Timer`` is the host-side section timer.  ``DeviceBench`` measures a
step's device time the way the JAX package's one compiled ``lax.scan`` of
K steps does: on CUDA it records the K calls into one CUDA graph and times
replays of it with CUDA events, so no host dispatch sits between the
steps.  ``measure_corrected`` is the two-K difference, which splits a
replay's time into a per-step term and a per-call constant.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


class Timer:
    """Accumulating section timer: with t.section("recv"): ..."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    def section(self, name: str):
        return _Section(self, name)

    def add(self, name: str, dt: float):
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: {"total_s": v, "count": self.counts[k], "mean_ms": v / self.counts[k] * 1e3}
            for k, v in self.totals.items()
        }


class _Section:
    def __init__(self, timer, name):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.t0 = time.time()

    def __exit__(self, *exc):
        self.timer.add(self.name, time.time() - self.t0)


def _step_input(xs, k: int):
    """The k-th step's input: xs[k] of a tensor, or of each tensor of a
    tuple (None entries stay None, as in the JAX pytree)."""
    if isinstance(xs, tuple):
        return tuple(None if a is None else a[k] for a in xs)
    return xs[k]


def _leading(xs) -> torch.Tensor:
    return next(a for a in xs if a is not None) if isinstance(xs, tuple) else xs


class DeviceBench:
    """Device timer for ``step_fn(params, x_k) -> tensor``.

    ``measure(params, xs)`` runs K steps, xs having a leading K axis, and
    adds each step's ``out.sum().float()`` into a float32 scalar on the
    device (the JAX scan's carry, so no step is dead work); ``total`` holds
    its value after the last run.

    On CUDA the K steps are recorded into one CUDA graph; warming up on a
    side stream and capturing is ``compile_s``.  The graph is replayed
    ``reps`` times, each replay timed with CUDA events, and the best is
    reported.  On the CPU the same K calls run under ``time.perf_counter``.
    Any other device raises."""

    def __init__(self, step_fn: Callable, reps: int = 3):
        self.step_fn = step_fn
        self.reps = reps
        self.total = None

    def _body(self, params, xs, acc, K):
        acc.zero_()
        for k in range(K):
            acc.add_(self.step_fn(params, _step_input(xs, k)).sum().float())

    def measure(self, params, xs) -> dict:
        lead = _leading(xs)
        K = lead.shape[0]
        dev = lead.device
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            times, compile_s = self._measure_cuda(params, xs, acc, K)
        elif dev.type == "cpu":
            t0 = time.perf_counter()
            self._body(params, xs, acc, K)
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(self.reps):
                t0 = time.perf_counter()
                self._body(params, xs, acc, K)
                times.append(time.perf_counter() - t0)
        else:
            raise ValueError(f"DeviceBench has no timer for device {dev}")
        self.total = float(acc)
        best = min(times)
        return {
            "per_iter_ms": best / K * 1e3,
            "total_s": best,
            "iters": K,
            "compile_s": compile_s,
            "reps_ms": [t * 1e3 for t in times],
        }

    def _measure_cuda(self, params, xs, acc, K):
        with torch.cuda.device(acc.device):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._body(params, xs, acc, K)  # builds kernels, warms allocators
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # relaxed: the kernels' C entry points set function attributes
            # while the stream is being captured
            with torch.cuda.graph(graph, capture_error_mode="relaxed"):
                self._body(params, xs, acc, K)
            graph.replay()
            torch.cuda.synchronize()
            compile_s = time.perf_counter() - t0
            times = []
            for _ in range(self.reps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
        return times, compile_s

    def measure_corrected(self, params, xs) -> dict:
        """Two-K differencing: measure the same step at K and at 4K (xs
        tiled along the leading axis) and split the time into
        per_iter_ms = (t(4K) - t(K)) / 3K and a per-call constant
        percall_const_ms = t(K) - K * per_iter_ms (on CUDA: what one graph
        launch costs beyond its steps).  Falls back to the raw value when
        the difference is not positive."""
        r = self.measure(params, xs)
        xs4 = (tuple(None if a is None else torch.cat([a] * 4) for a in xs)
               if isinstance(xs, tuple) else torch.cat([xs] * 4))
        r4 = self.measure(params, xs4)
        K = r["iters"]
        dev_ms = (r4["total_s"] - r["total_s"]) / (3 * K) * 1e3
        const_ms = r["total_s"] * 1e3 - K * dev_ms
        degenerate = dev_ms <= 0
        if degenerate:
            dev_ms, const_ms = r["per_iter_ms"], 0.0
        return {
            "per_iter_ms": dev_ms,
            "percall_const_ms": const_ms,
            "raw_per_iter_ms": r["per_iter_ms"],
            "raw_per_iter_ms_4k": r4["per_iter_ms"],
            "iters": K,
            "compile_s": r["compile_s"],
            "degenerate_fallback": degenerate,
        }
