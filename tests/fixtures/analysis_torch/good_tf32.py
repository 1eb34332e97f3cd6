"""Known-good: TF32 pinned off, as repro_torch/__init__.py pins it."""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
