"""qps.stream: queries whose scores reached sender 0 inside the window,
over the window's seconds (back-to-back cells; the window of a run that
profiles a stretch holds the stretch)."""

from portbench.readers import answered_queries


def read(out):
    return answered_queries(out) / out.seconds
