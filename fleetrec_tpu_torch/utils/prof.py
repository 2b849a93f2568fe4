"""Profiler hook, the port of ``fleetrec_tpu/utils/prof.py`` on
``torch.profiler``."""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def profile_trace(logdir: str, enabled: bool = True):
    """Trace the CPU and, when a card is present, CUDA activity of the
    block and write a Chrome trace (``trace.json``, for chrome://tracing or
    Perfetto) into ``logdir``.  Yields the profiler, or None when
    ``enabled`` is false, the only way to switch it off.  A profiler that
    fails to start raises."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
