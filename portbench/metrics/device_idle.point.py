"""Percent of a sweep's first timed point in which no operation ran on the
device: 1 - busy / window, busy the union of the device events'
intervals from ``torch.profiler``."""

from harness.trace import idle_share


def read(record):
    return idle_share(record)
