"""Tier gating: ``tier2``-marked tests (expensive end-to-end differential
suites) are skipped unless ``RUN_TIER2`` is set — the nightly / manual
CI job runs them (see ``.github/workflows/ci.yml``)."""

import os

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tier2: expensive end-to-end differential tests "
        "(nightly CI; set RUN_TIER2=1 to run locally)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card (repro_torch's kernels); skips without one",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RUN_TIER2"):
        return
    skip = pytest.mark.skip(
        reason="tier-2: set RUN_TIER2=1 (runs in the nightly CI job)")
    for item in items:
        if "tier2" in item.keywords:
            item.add_marker(skip)
