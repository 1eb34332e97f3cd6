"""Optimizer and gradient compression (counterpart of ``repro.optim``):
AdamW written out (``adamw``) and local int8 error feedback
(``compress``)."""
