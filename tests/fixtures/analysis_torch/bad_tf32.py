"""Known-bad: TF32 turned on."""
import torch

torch.backends.cuda.matmul.allow_tf32 = True
torch.backends.cudnn.allow_tf32 = 1
torch.set_float32_matmul_precision("high")
