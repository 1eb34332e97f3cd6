"""The dense decoder LM with analog execution hooks (counterpart of
``repro.models``)."""
