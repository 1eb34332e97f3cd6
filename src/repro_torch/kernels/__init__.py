"""Hand-written CUDA kernels of the serving path, their plain PyTorch
versions and the dispatching wrappers (counterpart of ``repro.kernels``).

``ops`` is the public surface; ``fused``, ``bitline`` and ``analog_mvm``
launch the kernels built from ``csrc/`` by ``build``; ``ref`` holds the
plain versions; ``tolerance`` states the bound a kernel is held to
against its plain version.  Nothing here builds or imports a compiler at
import time.
"""
