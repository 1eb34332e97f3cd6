"""Scale-out entry points (counterpart of ``repro.launch``): the meshes
(``mesh``), the sharded train, prefill and decode steps (``steps``), and
the dry-run tooling that counts them per device on a fake process group
of 256 or 512 ranks: ``op_stats`` (flops, HBM bytes and collective wire
bytes of the ops a step dispatches; ``hlo_stats``'s counterpart),
``dryrun`` (every arch x shape x mesh cell, no memory behind it) and
``roofline`` (its records against a device's peak rates)."""
