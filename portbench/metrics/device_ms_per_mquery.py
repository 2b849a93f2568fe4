"""device_ms_per_mquery: the device's busy time (the union of its
operations' intervals: kernels and copies) in the profiled stretch, over
the queries scored there (one score readback a batch), in ms a million
queries: the card's time that a query costs."""

from portbench.readers import stretch_queries, trace_of


def read(out):
    tr = trace_of(out)
    if tr is None or not tr.kernels:
        return None
    n = stretch_queries(tr, out.batch)
    return tr.busy_ns / 1e6 / (n / 1e6) if n else None
