"""The paper's analog MVM as composable PyTorch ops (counterpart of
``repro.core``)."""
