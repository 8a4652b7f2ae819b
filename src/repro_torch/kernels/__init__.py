"""Kernels written by hand for Hopper, each beside its plain PyTorch
version (``_build`` compiles the CUDA sources under ``csrc/``)."""
