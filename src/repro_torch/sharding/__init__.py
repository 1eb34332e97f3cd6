"""Sharding of the port's trees over a ``DeviceMesh`` (counterpart of
``repro.sharding``): the logical-axis rules (``rules``) and the
performance flags with their layout constraints (``perf``)."""
