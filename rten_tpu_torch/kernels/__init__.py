"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources live in ``rten_tpu_torch/csrc``; ``_build`` compiles them
at first use."""
