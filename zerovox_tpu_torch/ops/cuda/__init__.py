"""Hand-written CUDA kernels (sources under zerovox_tpu_torch/csrc/), each
beside its plain PyTorch version.  Nothing here builds at import time."""
