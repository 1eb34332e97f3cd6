"""Asynchronous, elastic checkpointing (counterpart of
``repro.checkpoint``)."""
