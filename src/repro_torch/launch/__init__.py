"""Scale-out entry points (counterpart of ``repro.launch``): the meshes
(``mesh``) and the sharded train, prefill and decode steps (``steps``)."""
