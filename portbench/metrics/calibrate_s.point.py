"""Seconds a completed design point spent in ``calibrate_lm`` (the sweep
evaluator's call), a span from the benchmark's files ended by a
synchronize; the mean over the window's completed points."""

from harness.trace import span_mean


def read(record):
    return span_mean(record, "calibrate")
