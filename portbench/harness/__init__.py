"""The benchmark harness: one general runner for every cell, driven by
the data files under ``portbench/`` (see ``portbench/README.md``)."""
