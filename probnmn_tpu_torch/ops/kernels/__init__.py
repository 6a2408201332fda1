r"""Hand-written Hopper kernels (CUDA C++ under ``probnmn_tpu_torch/csrc``),
each beside its plain PyTorch version and a launch counter."""
