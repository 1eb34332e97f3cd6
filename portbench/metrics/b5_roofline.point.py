"""Percent of its roofline that kernel B5 (`csrc/bitline.cu`) reached over
a sweep's first timed point: bound time (bytes at 3.35 TB/s or float32
operations at 67 TFLOP/s, the larger) over device time
(``harness.trace``)."""

from harness.trace import roofline_share


def read(record):
    return roofline_share(record, "b5")
