"""PyTorch/CUDA port of ``repro``: the paper's analog MVM serving a dense
decoder LM, on an NVIDIA H100.

The package mirrors ``repro``'s subpackages and module names
(``core``, ``hw``, ``kernels``, ``models``, ``serve``) so each function
has an obvious counterpart; the JAX package is the reference the port is
held against (``tests/test_torch_*.py``).  Nothing here imports ``jax``
or ``repro``.

Idiom, relative to the reference:

* parameters are nested dicts of tensors; a Python loop over layers
  replaces ``lax.scan`` and a written-out batch axis replaces ``vmap``;
* randomness comes from explicit seeds turned into ``torch.Generator``s
  (``serve.analog_engine.hook_key``), never from global RNG state;
* functions that create tensors from nothing (``models.transformer.
  init_params``, ``interop.load_params_npz`` / ``params_from_numpy`` /
  ``pack_from_numpy``) take ``device="cuda"`` by default and run on the
  CPU only when asked; everything else follows the device of the tensors
  it is given;
* the kernels (``kernels.fused``, ``kernels.bitline``,
  ``kernels.analog_mvm``) are CUDA C++ for ``sm_90a``; their wrappers run
  the plain PyTorch versions only for CPU tensors.

The reference pins ``Precision.HIGHEST`` on every float32 dot, so TF32 is
switched off here for matmuls and cuDNN alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
