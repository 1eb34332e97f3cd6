"""Registers the marker of the benchmark's tests that need a CUDA card
(the same marker as ``tests/``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (repro_torch's kernels); skips "
        "without one")
