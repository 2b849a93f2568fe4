"""What the metric readers (``metrics/<name>.py``) share: each reader is a
function ``read(out)`` of a run's ``serve.Outcome`` that returns the
metric's value, or None where the run holds nothing to read it from (it
never returns 0 for a share of a peak)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import inputs, yardstick

# the score readbacks: one device-to-host copy a served batch
READBACK = r"^Memcpy DtoH"


def trace_of(out):
    """The run's trace of its profiled stretch, or None."""
    return out.trace


def record_median_ms(out, a: int, b: int) -> Optional[float]:
    """Median over the window's engine records of stamp b - stamp a (0
    first byte, 1 submit, 2 done), in ms."""
    j = out.window()
    j = j[j < len(out.records)]
    if not len(j):
        return None
    r = out.records[j]
    return float(np.median((r[:, b] - r[:, a]) / 1e6))


def answered_queries(out) -> int:
    """Queries of the window whose scores reached sender 0."""
    j = out.window()
    return int((j < len(out.replies)).sum()) * out.batch


def per_call_s(tr, pattern: str, calls: Optional[int] = None) -> Optional[float]:
    """Device seconds of the operations matching ``pattern`` a call: a
    call is one matching operation, or one of ``calls`` when given."""
    n = tr.count(pattern) if calls is None else calls
    return tr.seconds(pattern) / n if n and tr.count(pattern) else None


def stretch_queries(tr, batch: int) -> int:
    """Queries scored in a trace's stretch: one score readback a batch."""
    return tr.count(READBACK) * batch


def idle_percent(out) -> Optional[float]:
    tr = trace_of(out)
    return None if tr is None else 100.0 * (1.0 - tr.busy_ns / (tr.end - tr.start))


def window_lookup_bytes(out) -> float:
    """The mean of ``yardstick.lookup_bytes`` over the window's batches."""
    m, P = out.cell.model, out.cell.traffic["pool_batches"]
    ids = inputs.pools(out.seed, m, out.batch, P)[0]
    per = np.asarray([yardstick.lookup_bytes(m, ids[p]) for p in range(P)], np.float64)
    j = out.window()
    return float(per[j % P].mean()) if len(j) else float(per.mean())
