"""device_idle: the share of the profiled stretch (first to last device
operation of the card) in which no device operation ran, in %."""

from portbench.readers import idle_percent


def read(out):
    return idle_percent(out)
