"""The benchmark's plain reference: ``analog.py`` (the arrays),
``model.py`` (the two model families), ``lm.py`` (a design point)."""
