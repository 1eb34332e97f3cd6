"""Percent of the card's float32 peak (67 TFLOP/s) that the window's
completed design points did, up to the last one: 2 flops per analog
weight per token through the arrays (calibration's two passes, eval,
decode) plus attention's (``harness.sweep``)."""

from harness.work import FP32_FLOPS


def read(record):
    n, t = record.get("points_done", 0), record.get("window_to_last_s", 0.0)
    if not n or t <= 0.0:
        return None
    return 100.0 * record["point_flops"] * n / (t * FP32_FLOPS)
