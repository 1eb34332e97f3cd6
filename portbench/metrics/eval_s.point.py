"""Seconds a completed design point spent in ``analog_eval_metrics`` and
``decode_lm`` (the evaluator's eval and decode), a span from the
benchmark's files ended by a synchronize; the mean over the window's
completed points."""

from harness.trace import span_mean


def read(record):
    return span_mean(record, "eval")
