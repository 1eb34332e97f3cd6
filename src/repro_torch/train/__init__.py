"""Training (counterpart of ``repro.train``): the loss and the
microbatched AdamW step (``step``)."""
